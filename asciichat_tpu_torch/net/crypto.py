"""Crypto core: X25519 key exchange + XSalsa20-Poly1305 secretbox + rekeying.

Parity with lib/crypto/crypto.c:
- key pair / shared key: X25519; the raw scalarmult output IS the secretbox
  key (crypto.c:264-266, no KDF)
- encryption format:     nonce(24) || MAC(16) || ciphertext
  (crypto_encrypt, crypto.c:486-505)
- nonce layout:          session_id(16) || big-endian counter(8), counter
  starts at 1 (generate_nonce, crypto.c:54-73)
- auth:                  HMAC-SHA256 over the 32-byte challenge nonce with the
  shared key (crypto.c:837-885)
- rekeying:              new ephemeral X25519 pair after 1M packets or 1h
  (crypto.c:143-155, REKEY_* thresholds), REQUEST/RESPONSE/COMPLETE
- password mode:         Argon2id (native/argon2.cpp, RFC 9106) with the
  reference's effective libsodium parameters — wire-format parity
  (crypto.c:336-352).

The cipher itself lives in native/sodium.cpp (own implementation of the
public Salsa20/Poly1305 specs); _py_* functions are an independent
pure-Python implementation used to cross-validate it in tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import hmac as hmac_mod
import os
import struct
import time

from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey,
    X25519PublicKey,
)

KEY_SIZE = 32
NONCE_SIZE = 24
MAC_SIZE = 16
SESSION_ID_SIZE = 16
AUTH_CHALLENGE_SIZE = 32

REKEY_PACKET_THRESHOLD = 1_000_000  # crypto.c:154
REKEY_TIME_THRESHOLD_S = 3600.0  # crypto.c:155


@functools.lru_cache(maxsize=1)
def _lib():
    from asciichat_tpu_torch.runtime.kernel_build import native_lib

    lib = native_lib("sodium")
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.ac_secretbox_easy.argtypes = [u8, ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_char_p, ctypes.c_char_p]
    lib.ac_secretbox_easy.restype = ctypes.c_int
    lib.ac_secretbox_open_easy.argtypes = [u8, ctypes.c_char_p, ctypes.c_uint64,
                                           ctypes.c_char_p, ctypes.c_char_p]
    lib.ac_secretbox_open_easy.restype = ctypes.c_int
    lib.ac_poly1305.argtypes = [u8, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.ac_hsalsa20.argtypes = [u8, ctypes.c_char_p, ctypes.c_char_p]
    return lib


@functools.lru_cache(maxsize=1)
def _argon2_lib():
    from asciichat_tpu_torch.runtime.kernel_build import native_lib

    lib = native_lib("argon2")
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u32 = ctypes.c_uint32
    lib.ac_argon2id.argtypes = [ctypes.c_char_p, u32, ctypes.c_char_p, u32,
                                u32, u32, u32, ctypes.c_char_p, u32,
                                ctypes.c_char_p, u32, u8, u32]
    lib.ac_argon2id.restype = ctypes.c_int
    return lib


def argon2id(password: bytes, salt: bytes, t: int = 2, m_kib: int = 65536,
             parallelism: int = 1, outlen: int = 32,
             secret: bytes = b"", ad: bytes = b"") -> bytes:
    """Argon2id v1.3 (RFC 9106) from native/argon2.cpp — the reference's
    crypto_pwhash counterpart (crypto.c:348). Validated against the RFC §5.3
    vector and two independent implementations in tests/test_crypto.py."""
    out = (ctypes.c_uint8 * outlen)()
    rc = _argon2_lib().ac_argon2id(
        password, len(password), salt, len(salt), t, m_kib, parallelism,
        secret or None, len(secret), ad or None, len(ad), out, outlen,
    )
    if rc != 0:
        raise ValueError(f"argon2id failed (rc={rc})")
    return bytes(out)


def secretbox(message: bytes, nonce: bytes, key: bytes) -> bytes:
    """-> MAC(16) || ciphertext (crypto_secretbox_easy format)."""
    # real raises, not asserts: these guard fixed-size native reads and must
    # survive `python -O` (a short buffer would be an OOB read in sodium.cpp)
    if len(nonce) != NONCE_SIZE or len(key) != KEY_SIZE:
        raise ValueError("bad nonce/key length")
    out = (ctypes.c_uint8 * (MAC_SIZE + len(message)))()
    _lib().ac_secretbox_easy(out, message, len(message), nonce, key)
    return bytes(out)


def secretbox_open(boxed: bytes, nonce: bytes, key: bytes) -> bytes:
    """Verify + decrypt; raises ValueError on MAC failure."""
    if len(nonce) != NONCE_SIZE or len(key) != KEY_SIZE:
        raise ValueError("bad nonce/key length")
    if len(boxed) < MAC_SIZE:
        raise ValueError("ciphertext too short")
    out = (ctypes.c_uint8 * (len(boxed) - MAC_SIZE))()
    rc = _lib().ac_secretbox_open_easy(out, boxed, len(boxed), nonce, key)
    if rc != 0:
        raise ValueError("secretbox MAC verification failed")
    return bytes(out)


# ---------------------------------------------------------------------------
# Independent pure-Python reference (spec-derived) for cross-validation.

_SIGMA = b"expand 32-byte k"


def _rotl(v, n):
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


def _salsa20_rounds(x: list[int]) -> None:
    for _ in range(10):
        for a, b, c, d in ((0, 4, 8, 12), (5, 9, 13, 1), (10, 14, 2, 6), (15, 3, 7, 11)):
            x[b] ^= _rotl((x[a] + x[d]) & 0xFFFFFFFF, 7)
            x[c] ^= _rotl((x[b] + x[a]) & 0xFFFFFFFF, 9)
            x[d] ^= _rotl((x[c] + x[b]) & 0xFFFFFFFF, 13)
            x[a] ^= _rotl((x[d] + x[c]) & 0xFFFFFFFF, 18)
        for a, b, c, d in ((0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14)):
            x[b] ^= _rotl((x[a] + x[d]) & 0xFFFFFFFF, 7)
            x[c] ^= _rotl((x[b] + x[a]) & 0xFFFFFFFF, 9)
            x[d] ^= _rotl((x[c] + x[b]) & 0xFFFFFFFF, 13)
            x[a] ^= _rotl((x[d] + x[c]) & 0xFFFFFFFF, 18)


def _salsa20_state(key: bytes, n16: bytes) -> list[int]:
    k = struct.unpack("<8I", key)
    nn = struct.unpack("<4I", n16)
    s = struct.unpack("<4I", _SIGMA)
    return [s[0], k[0], k[1], k[2], k[3], s[1], nn[0], nn[1],
            nn[2], nn[3], s[2], k[4], k[5], k[6], k[7], s[3]]


def _py_hsalsa20(key: bytes, n16: bytes) -> bytes:
    x = _salsa20_state(key, n16)
    _salsa20_rounds(x)
    idx = (0, 5, 10, 15, 6, 7, 8, 9)
    return struct.pack("<8I", *(x[i] for i in idx))


def _py_salsa20_block(key: bytes, n8: bytes, counter: int) -> bytes:
    x0 = _salsa20_state(key, n8 + struct.pack("<Q", counter))
    x = list(x0)
    _salsa20_rounds(x)
    return struct.pack("<16I", *(((a + b) & 0xFFFFFFFF) for a, b in zip(x, x0)))


def _py_poly1305(msg: bytes, key: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block, "little") + (1 << (8 * len(block)))
        acc = ((acc + n) * r) % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _py_secretbox(message: bytes, nonce: bytes, key: bytes) -> bytes:
    subkey = _py_hsalsa20(key, nonce[:16])
    block0 = _py_salsa20_block(subkey, nonce[16:], 0)
    poly_key = block0[:32]
    ct = bytearray()
    head = min(len(message), 32)
    ct += bytes(a ^ b for a, b in zip(message[:head], block0[32 : 32 + head]))
    i = 32
    counter = 1
    while i < len(message):
        block = _py_salsa20_block(subkey, nonce[16:], counter)
        chunk = message[i : i + 64]
        ct += bytes(a ^ b for a, b in zip(chunk, block))
        i += 64
        counter += 1
    tag = _py_poly1305(bytes(ct), poly_key)
    return tag + bytes(ct)


# ---------------------------------------------------------------------------
# Context + handshake state


@dataclasses.dataclass
class RekeyState:
    packet_count: int = 0
    last_time: float = dataclasses.field(default_factory=time.monotonic)
    in_progress: bool = False
    started_at: float = 0.0  # when in_progress was set (stall detection)
    count: int = 0


class CryptoContext:
    """Per-connection crypto state (crypto_context_t analog)."""

    def __init__(
        self,
        packet_threshold: int = REKEY_PACKET_THRESHOLD,
        time_threshold_s: float = REKEY_TIME_THRESHOLD_S,
    ):
        self._private = X25519PrivateKey.generate()
        self.public_key = self._private.public_key().public_bytes_raw()
        self.shared_key: bytes | None = None
        self.session_id = os.urandom(SESSION_ID_SIZE)
        self.previous_session_id: bytes | None = None
        self.nonce_counter = 1  # crypto.c:114 (0 reserved)
        # encrypt() is reached from BOTH the event loop and executor ticks
        # (SecureChannel.send_nowait); an unguarded counter could hand two
        # threads the same nonce — catastrophic for XSalsa20-Poly1305
        import threading

        self._nonce_lock = threading.Lock()
        self.handshake_complete = False
        self.rekey = RekeyState()
        self.packet_threshold = packet_threshold
        self.time_threshold_s = time_threshold_s
        self._temp_private: X25519PrivateKey | None = None
        self._temp_public: bytes = b""
        self.password_key: bytes | None = None
        self.previous_key: bytes | None = None
        self._previous_key_expiry = 0.0
        self._pending_key: bytes | None = None
        self._last_incoming_rekey = 0.0
        self.auth_nonce: bytes | None = None

    # -- key exchange ----------------------------------------------------
    def compute_shared(self, peer_public: bytes) -> None:
        """Raw X25519 output is the secretbox key (crypto.c:264-266)."""
        self.shared_key = self._private.exchange(X25519PublicKey.from_public_bytes(peer_public))

    def set_password(self, password: str) -> None:
        """Password key via Argon2id (native/argon2.cpp, RFC 9106), with the
        reference's exact effective parameters (crypto.c:336-352): libsodium
        crypto_pwhash INTERACTIVE limits (t=2, m=64 MiB, p=1) and the
        deterministic salt "ascii-chat-password-salt-v1" — of which libsodium
        reads crypto_pwhash_SALTBYTES=16 bytes, so the effective salt is the
        first 16 bytes. Wire-format parity for password sessions."""
        self.password_key = argon2id(
            password.encode(), b"ascii-chat-password-salt-v1"[:16],
            t=2, m_kib=64 * 1024, parallelism=1, outlen=32,
        )

    @property
    def _key(self) -> bytes:
        key = self.shared_key or self.password_key
        if key is None:
            raise ValueError("no encryption key (handshake incomplete)")
        return key

    # -- nonce + packet encryption ----------------------------------------
    def encrypt(self, plaintext: bytes) -> bytes:
        """-> nonce(24) || MAC(16) || ct (crypto_encrypt, crypto.c:486-505).

        The (nonce, key) pair is read atomically under _nonce_lock:
        _commit_pending swaps session_id/counter/key under the same lock, so
        an executor-thread encrypt can never pair an old-session nonce with
        the new key (or re-send old_session||1, which the peer's replay
        window would reject, tearing down a healthy session at rekey time)."""
        with self._nonce_lock:
            nonce = self.session_id + struct.pack(">Q", self.nonce_counter)
            self.nonce_counter += 1
            self.rekey.packet_count += 1
            key = self.shared_key or self.password_key
        if key is None:
            raise ValueError("no encryption key (handshake incomplete)")
        return nonce + secretbox(plaintext, nonce, key)

    def decrypt(self, ciphertext: bytes) -> bytes:
        if len(ciphertext) < NONCE_SIZE + MAC_SIZE:
            raise ValueError("ciphertext too short")
        nonce = ciphertext[:NONCE_SIZE]
        try:
            return secretbox_open(ciphertext[NONCE_SIZE:], nonce, self._key)
        except ValueError:
            # A packet that decrypts under the PENDING rekey key is
            # proof-of-possession: the peer demonstrably holds the new shared
            # secret, so commit it now. This matches the reference's rule that
            # a rekey only takes effect once REKEY_COMPLETE verifies under the
            # new key (handshake/common.c:586+, crypto.c:1225) — and also
            # covers data packets that overtake the COMPLETE in flight.
            if self._pending_key is not None:
                try:
                    out = secretbox_open(
                        ciphertext[NONCE_SIZE:], nonce, self._pending_key
                    )
                except ValueError:
                    pass
                else:
                    self._commit_pending()
                    return out
            # packets encrypted under the pre-rekey key may still be in
            # flight; accept them ONLY during a short transition window — the
            # reference zeroizes the old key at rekey commit (crypto.c:1322),
            # so the old key must actually retire (forward security).
            if self.previous_key is not None:
                if time.monotonic() >= self._previous_key_expiry:
                    self.previous_key = None
                    raise
                return secretbox_open(ciphertext[NONCE_SIZE:], nonce, self.previous_key)
            raise

    # -- authentication ----------------------------------------------------
    def make_challenge(self) -> bytes:
        self.auth_nonce = os.urandom(AUTH_CHALLENGE_SIZE)
        return self.auth_nonce

    def answer_challenge(self, challenge: bytes) -> bytes:
        """HMAC-SHA256 over challenge||shared_key, keyed by the password key
        when one exists else the shared key (crypto.c:927-963: combined_data =
        nonce(32)||shared_key(32), auth_key = password_key ?: shared_key)."""
        # The DH binding is mandatory: the reference refuses auth before key
        # exchange completes (crypto.c:927-963), preventing a MITM from
        # silently stripping the shared-secret binding in password sessions.
        if self.shared_key is None:
            raise ValueError("auth challenge before key exchange completed")
        data = challenge + self.shared_key
        key = self.password_key if self.password_key is not None else self.shared_key
        return hmac_mod.new(key, data, hashlib.sha256).digest()

    def verify_challenge_answer(self, answer: bytes) -> bool:
        if self.auth_nonce is None:
            return False  # answer without a prior challenge: auth failure,
            # not an AttributeError crash
        want = self.answer_challenge(self.auth_nonce)
        return hmac_mod.compare_digest(want, answer)

    # -- rekeying ----------------------------------------------------------
    def needs_rekey(self) -> bool:
        """1M packets or 1 hour (crypto.c:143-155)."""
        return (
            self.rekey.packet_count >= self.packet_threshold
            or time.monotonic() - self.rekey.last_time >= self.time_threshold_s
        )

    REKEY_STALL_TIMEOUT_S = 30.0

    def start_rekey(self) -> bytes:
        """-> new ephemeral public key (REKEY_REQUEST payload)."""
        self._temp_private = X25519PrivateKey.generate()
        self._temp_public = self._temp_private.public_key().public_bytes_raw()
        self.rekey.in_progress = True
        self.rekey.started_at = time.monotonic()
        return self._temp_public

    def rekey_stalled(self) -> bool:
        """A REKEY_RESPONSE that never arrives (lost packet, rate-limited
        responder) must not leave in_progress latched forever — that would
        silently disable the 1M-packet/1-hour forward-security thresholds
        for the rest of the session."""
        return (self.rekey.in_progress
                and time.monotonic() - self.rekey.started_at
                > self.REKEY_STALL_TIMEOUT_S)

    def abandon_rekey(self) -> None:
        self._temp_private = None
        self.rekey.in_progress = False

    PREVIOUS_KEY_GRACE_S = 5.0
    MIN_INCOMING_REKEY_INTERVAL_S = 5.0

    def allow_incoming_rekey(self) -> bool:
        """Rate limit on incoming rekey requests: an injected/replayed
        plaintext REKEY_REQUEST must not be able to churn the session
        (crypto.c rate-limits requests)."""
        now = time.monotonic()
        if now - self._last_incoming_rekey < self.MIN_INCOMING_REKEY_INTERVAL_S:
            return False
        self._last_incoming_rekey = now
        return True

    def respond_rekey(self, peer_new_public: bytes) -> bytes:
        """Responder side: derive the new shared key but hold it PENDING —
        the current key stays active until the peer proves possession (any
        packet decrypting under the pending key commits it, see decrypt()).
        Returns our fresh ephemeral public key FOLLOWED BY an echo of the
        request's public key: the echo binds the response to the request it
        answers, so an initiator that abandoned a stalled rekey and started
        a new one can detect (and ignore) the LATE response to the old
        request instead of committing DH(new_priv, old_resp) — a key the
        responder never computed, which would MAC-fail every subsequent
        packet and tear the session down. finish_rekey tolerates a bare
        32-byte response for compatibility."""
        temp = X25519PrivateKey.generate()
        self._pending_key = temp.exchange(
            X25519PublicKey.from_public_bytes(peer_new_public)
        )
        return temp.public_key().public_bytes_raw() + peer_new_public[:32]

    def _commit_pending(self) -> None:
        # under _nonce_lock: encrypt() reads (session_id, counter, key) as
        # one atomic snapshot, so the whole swap must be one atomic write
        with self._nonce_lock:
            self.previous_key = self.shared_key
            self._previous_key_expiry = (time.monotonic()
                                         + self.PREVIOUS_KEY_GRACE_S)
            self.shared_key = self._pending_key
            self._pending_key = None
            self._temp_private = None
            self.rekey = RekeyState(count=self.rekey.count + 1)
            self.nonce_counter = 1
            # remember the outgoing nonce prefix we used before the rekey:
            # the channel's reflection check must keep rejecting our own OLD
            # packets bounced back during the previous-key grace window
            self.previous_session_id = self.session_id
            self.session_id = os.urandom(SESSION_ID_SIZE)

    def finish_rekey(self, response: bytes) -> None:
        """Initiator side: install the new shared key (crypto.c:1298-1341).
        `response` = responder_pub(32) [+ echo of our request pub(32)].
        Raises ValueError on an unsolicited rekey response (no rekey in
        progress) — the reference returns CRYPTO_ERROR_REKEY_FAILED for this
        state instead of crashing the connection — or on a response whose
        echo names a DIFFERENT (abandoned) request: committing that key
        would desync the session (see respond_rekey)."""
        if self._temp_private is None:
            raise ValueError("no rekey in progress")
        if len(response) >= 64 and response[32:64] != self._temp_public:
            raise ValueError("rekey response answers a stale request")
        self._pending_key = self._temp_private.exchange(
            X25519PublicKey.from_public_bytes(response[:32])
        )
        self._commit_pending()
