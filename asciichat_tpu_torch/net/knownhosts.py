"""Server host-key pinning for key-authenticated sessions.

Counterpart of lib/crypto/known_hosts.c: in SSH/GPG identity mode the
password-mode mutual-auth HMAC does not exist, so without this an
impostor server could accept the client's signature and stream to/from
it (MITM). The server proves a persistent Ed25519 HOST identity by
signing the client's fresh challenge bound to the DH shared key; the
client verifies the proof and TOFU-pins the host key per "host:port" in
a known_hosts file — exactly the SSH model.

Proof format (CRYPTO_SERVER_AUTH_RESP in key mode):
    host_pub(32) || sig(64) over CONTEXT || client_challenge || shared_key
"""

from __future__ import annotations

import os
from pathlib import Path

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

CONTEXT = b"ascii-chat-host-auth-v1"
DEFAULT_PATH = "~/.asciichat/known_hosts"


class HostKeyError(ValueError):
    pass


def sign_host_proof(identity, client_challenge: bytes, shared_key: bytes) -> bytes:
    """Server side: identity is net/identity.Identity (Ed25519)."""
    msg = CONTEXT + client_challenge + shared_key
    sig = identity.raw_sign(msg)
    return identity.public_bytes + sig


def verify_host_proof(blob: bytes, client_challenge: bytes,
                      shared_key: bytes) -> bytes:
    """Client side: -> the proven host public key, or raises HostKeyError."""
    if len(blob) < 96:
        raise HostKeyError("short host proof")
    pub, sig = blob[:32], blob[32:96]
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(
            sig, CONTEXT + client_challenge + shared_key)
    except (InvalidSignature, ValueError) as e:
        raise HostKeyError(f"host proof verification failed: {e}") from None
    return pub


class KnownHosts:
    """TOFU pin store, one 'host:port ed25519 <hex>' line per server."""

    def __init__(self, path: str | None = None):
        self.path = Path(os.path.expanduser(
            path or os.environ.get("ASCIICHAT_KNOWN_HOSTS", DEFAULT_PATH)))
        self._pins: dict[str, bytes] = {}
        try:
            lines = self.path.read_text().splitlines()
        except OSError:
            lines = []
        for line in lines:
            parts = line.split()
            if len(parts) == 3 and parts[1] == "ed25519":
                try:
                    self._pins[parts[0]] = bytes.fromhex(parts[2])
                except ValueError:
                    # ONE corrupt line must not abort loading the rest: a
                    # loop-wide except dropped every later pin, and the
                    # next _save rewrote the file without them — silently
                    # re-opening the TOFU window for those servers
                    continue

    def check(self, server_id: str, pubkey: bytes) -> str:
        """'ok' for a matching pin, 'new' after pinning a first-seen server;
        raises HostKeyError on mismatch (the ssh known_hosts behavior)."""
        pinned = self._pins.get(server_id)
        if pinned is None:
            self._pins[server_id] = pubkey
            self._save()
            return "new"
        if pinned != pubkey:
            raise HostKeyError(
                f"HOST KEY MISMATCH for {server_id}: pinned "
                f"{pinned.hex()[:16]}…, server presented {pubkey.hex()[:16]}… "
                f"(possible MITM; remove the line from {self.path} only if "
                "the server key legitimately changed)")
        return "ok"

    def _save(self) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # re-read and MERGE before the atomic replace: two processes
            # that both loaded the file before either saved would otherwise
            # clobber each other's first-seen pins (last writer wins),
            # silently re-TOFU-ing the lost server on its next connect.
            # Our in-memory pins win conflicts (we may have just verified a
            # legitimate key change); disk-only pins are preserved.
            merged: dict[str, bytes] = {}
            try:
                for line in self.path.read_text().splitlines():
                    parts = line.split()
                    if len(parts) == 3 and parts[1] == "ed25519":
                        try:
                            merged[parts[0]] = bytes.fromhex(parts[2])
                        except ValueError:
                            continue
            except OSError:
                pass
            merged.update(self._pins)
            self._pins = merged
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text("".join(
                f"{sid} ed25519 {key.hex()}\n" for sid, key in self._pins.items()))
            tmp.replace(self.path)
            os.chmod(self.path, 0o600)
        except OSError:
            pass  # read-only home: pins stay in-memory for this run
