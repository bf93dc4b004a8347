"""Ed25519 identities + signed ACDS subprotocol envelopes.

The reference signs its ACDS packets with Ed25519 identity keys (packed
structs + signatures, acds.h; crypto identity keys in lib/crypto/crypto.c) so
discovery-service traffic — session creation, joins, metrics, host
designations — cannot be forged by an on-path attacker or another
participant. This module is the TPU framework's counterpart:

- Identity: an Ed25519 keypair (ephemeral, or persisted to a key file).
- Envelope: every ACDS subprotocol payload travels as
      pubkey(32) || sig(64) || ts_ms(8) || body
  where sig = Ed25519(key, be16(packet_type) || ts_ms || body). Binding
  the packet type prevents cross-type replay (a signed NETWORK_QUALITY
  body can't be re-presented as a HOST_ANNOUNCEMENT), and the signed
  timestamp bounds same-type replay: envelopes older than the freshness
  window are rejected, so a recorded session-create or host announcement
  cannot be re-presented after the victim leaves.
- Pinning (known-hosts style): the first key seen for a participant-id (or
  for the ACDS itself) is pinned; later envelopes must verify under the
  pinned key. An imposter presenting a fresh key for a known id is rejected.
"""

from __future__ import annotations

import struct
from contextlib import suppress as contextlib_suppress
from pathlib import Path

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

PUBKEY_SIZE = 32
SIG_SIZE = 64
TS_SIZE = 8
ENVELOPE_OVERHEAD = PUBKEY_SIZE + SIG_SIZE + TS_SIZE
FRESHNESS_WINDOW_S = 300.0  # clock-skew tolerance for signed envelopes


class SignatureError(ValueError):
    pass


class Identity:
    """An Ed25519 signing identity (crypto.c identity-key analog)."""

    def __init__(self, private: Ed25519PrivateKey | None = None):
        self._private = private or Ed25519PrivateKey.generate()
        self.public_bytes = self._private.public_key().public_bytes_raw()

    @staticmethod
    def load_or_create(path: str | Path) -> "Identity":
        """Persistent identity: 32-byte raw seed file (0600).

        A short/corrupt file (crash or full disk mid-write) raises a clear
        ValueError naming the file instead of a bare cryptography traceback;
        creation writes tmp-then-rename so a crash can never leave a
        truncated key for the next start to trip over."""
        import os as _os

        p = Path(path)
        if p.exists():
            raw = p.read_bytes()
            if len(raw) < 32:
                raise ValueError(
                    f"corrupt identity key file {p} ({len(raw)} bytes, "
                    f"expected a 32-byte seed) — delete it to regenerate")
            return Identity(Ed25519PrivateKey.from_private_bytes(raw[:32]))
        ident = Identity()
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + f".tmp{_os.getpid()}")
        fd = _os.open(tmp, _os.O_WRONLY | _os.O_CREAT | _os.O_TRUNC, 0o600)
        try:
            with _os.fdopen(fd, "wb") as f:
                f.write(ident._private.private_bytes_raw())
            _os.replace(tmp, p)
        except BaseException:
            with contextlib_suppress(OSError):
                _os.unlink(tmp)
            raise
        return ident

    def sign(self, ptype: int, body: bytes) -> bytes:
        """-> pubkey(32) || sig(64) || ts_ms(8) || body."""
        import time as _time

        ts = struct.pack(">Q", int(_time.time() * 1000))
        sig = self._private.sign(struct.pack(">H", ptype & 0xFFFF) + ts + body)
        return self.public_bytes + sig + ts + body

    def raw_sign(self, data: bytes) -> bytes:
        """Plain Ed25519 signature over raw bytes (no envelope framing) —
        for protocols with their own message format (the known_hosts host
        proof). Keeps _private an implementation detail so the key can
        move behind an agent/HSM signer without breaking callers."""
        return self._private.sign(data)

    @property
    def id_hex(self) -> str:
        return self.public_bytes.hex()


def open_envelope(ptype: int, enveloped: bytes) -> tuple[bytes, bytes]:
    """Verify and strip an envelope -> (signer_pubkey, body).
    Raises SignatureError on truncation, a bad signature, or a stale
    timestamp (same-type replay beyond the freshness window)."""
    import time as _time

    if len(enveloped) < ENVELOPE_OVERHEAD:
        raise SignatureError("enveloped payload too short")
    pub = enveloped[:PUBKEY_SIZE]
    sig = enveloped[PUBKEY_SIZE : PUBKEY_SIZE + SIG_SIZE]
    ts_raw = enveloped[PUBKEY_SIZE + SIG_SIZE : ENVELOPE_OVERHEAD]
    body = enveloped[ENVELOPE_OVERHEAD:]
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(
            sig, struct.pack(">H", ptype & 0xFFFF) + ts_raw + body
        )
    except (InvalidSignature, ValueError) as e:
        raise SignatureError(f"bad envelope signature: {e}") from None
    (ts_ms,) = struct.unpack(">Q", ts_raw)
    if abs(_time.time() * 1000 - ts_ms) > FRESHNESS_WINDOW_S * 1000:
        raise SignatureError(
            f"stale envelope (signed {ts_ms}, window {FRESHNESS_WINDOW_S}s)")
    return pub, body


class KnownPeers:
    """First-use key pinning (the reference's known-hosts-style identity
    store): name -> pinned pubkey. `check` pins on first sight and raises on
    any later mismatch."""

    def __init__(self):
        self._pins: dict[str, bytes] = {}

    def check(self, name: str, pubkey: bytes) -> None:
        pinned = self._pins.get(name)
        if pinned is None:
            self._pins[name] = pubkey
        elif pinned != pubkey:
            raise SignatureError(
                f"identity key mismatch for {name!r}: "
                f"pinned {pinned.hex()[:16]}…, got {pubkey.hex()[:16]}…"
            )

    def require(self, name: str, pubkey: bytes) -> None:
        """Verify against an EXISTING pin only — never pins on first use.
        For channels where the legitimate binding arrives out-of-band (the
        ACDS-signed participant list): an unknown sender must be rejected,
        not trusted-and-pinned (first-use pinning there would let any
        stranger squat an identity by racing the legitimate binding)."""
        pinned = self._pins.get(name)
        if pinned is None:
            raise SignatureError(f"no pinned identity for {name!r}")
        if pinned != pubkey:
            raise SignatureError(
                f"identity key mismatch for {name!r}: "
                f"pinned {pinned.hex()[:16]}…, got {pubkey.hex()[:16]}…"
            )

    def get(self, name: str) -> bytes | None:
        return self._pins.get(name)

    def forget(self, name: str) -> None:
        self._pins.pop(name, None)
