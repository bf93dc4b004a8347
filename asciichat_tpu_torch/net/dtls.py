"""DTLS 1.2 endpoint over the system libssl (ctypes) — the browser-interop
security layer for WebRTC DataChannels.

Role parity: the reference's WebRTC transport (lib/network/webrtc/webrtc.c,
via libdatachannel) secures DataChannels with certificate-based DTLS whose
trust anchor is the SDP a=fingerprint line, relayed through authenticated
signaling. This module provides the same layer with what a stock Linux host
has: OpenSSL 3's DTLS implementation driven sans-io through
memory BIOs, with self-signed ECDSA P-256 identities and SHA-256 fingerprint
pinning (the signaling blob rides Ed25519-signed envelopes, net/identity.py,
so the fingerprint channel is authenticated exactly like the browser's
signaling server is trusted in WebRTC).

Design notes:
- Sans-io: `DtlsEndpoint` never touches a socket. Datagrams go in via
  `incoming()`, come out via `outgoing()`; the caller (net/datachannel.py)
  owns the carrier (the nominated ICE pair). This keeps the state machine
  unit-testable through lossy in-memory links and lets the SAME endpoint run
  over any datagram transport.
- Outgoing datagram framing: OpenSSL writes DTLS records back-to-back into
  the memory BIO; records must never split across datagrams (RFC 6347 §4.1:
  a record must fit one datagram, multiple records may share one). We parse
  the 13-byte record headers and greedily pack whole records up to the MTU.
- Handshake retransmission: DTLS retransmits flights on timers (RFC 6347
  §4.2.4); `timeout()`/`handle_timeout()` expose OpenSSL's timer so the
  asyncio side can schedule it.
- No HelloVerifyRequest cookie exchange: the DoS-protection round-trip is
  optional for the server (we only answer on an ICE-nominated pair, which
  already proved reachability), and browsers interoperate without it.

The port's copy of ``asciichat_tpu/net/dtls.py``.
"""

from __future__ import annotations

import ctypes
import threading
import os
import subprocess
import tempfile

from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("dtls")

# --- libssl/libcrypto bindings ----------------------------------------------

_ssl = None
_crypto = None
_load_error: str | None = None


def _load():
    global _ssl, _crypto, _load_error
    if _ssl is not None or _load_error is not None:
        return
    try:
        _crypto = ctypes.CDLL("libcrypto.so.3", mode=ctypes.RTLD_GLOBAL)
        _ssl = ctypes.CDLL("libssl.so.3")
    except OSError as e:  # pragma: no cover - environment without OpenSSL 3
        _load_error = str(e)
        return
    c, s = _crypto, _ssl
    s.SSL_CTX_new.restype = ctypes.c_void_p
    s.SSL_CTX_new.argtypes = [ctypes.c_void_p]
    s.DTLS_method.restype = ctypes.c_void_p
    s.SSL_new.restype = ctypes.c_void_p
    s.SSL_new.argtypes = [ctypes.c_void_p]
    s.SSL_free.argtypes = [ctypes.c_void_p]
    s.SSL_CTX_free.argtypes = [ctypes.c_void_p]
    s.SSL_set_bio.argtypes = [ctypes.c_void_p] * 3
    s.SSL_set_accept_state.argtypes = [ctypes.c_void_p]
    s.SSL_set_connect_state.argtypes = [ctypes.c_void_p]
    s.SSL_do_handshake.argtypes = [ctypes.c_void_p]
    s.SSL_get_error.argtypes = [ctypes.c_void_p, ctypes.c_int]
    s.SSL_is_init_finished.argtypes = [ctypes.c_void_p]
    s.SSL_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    s.SSL_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    s.SSL_shutdown.argtypes = [ctypes.c_void_p]
    s.SSL_ctrl.restype = ctypes.c_long
    s.SSL_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                           ctypes.c_void_p]
    s.SSL_CTX_ctrl.restype = ctypes.c_long
    s.SSL_CTX_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                               ctypes.c_void_p]
    s.SSL_set_options.restype = ctypes.c_uint64
    s.SSL_set_options.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    s.SSL_CTX_set_verify.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
    s.SSL_CTX_use_certificate.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    s.SSL_CTX_use_PrivateKey.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    s.SSL_CTX_set_cipher_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    s.SSL_get1_peer_certificate.restype = ctypes.c_void_p
    s.SSL_get1_peer_certificate.argtypes = [ctypes.c_void_p]
    s.DTLS_set_timer_cb.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    c.BIO_new.restype = ctypes.c_void_p
    c.BIO_new.argtypes = [ctypes.c_void_p]
    c.BIO_s_mem.restype = ctypes.c_void_p
    c.BIO_free.argtypes = [ctypes.c_void_p]
    c.BIO_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    c.BIO_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    c.BIO_ctrl.restype = ctypes.c_long
    c.BIO_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                           ctypes.c_void_p]
    c.BIO_new_mem_buf.restype = ctypes.c_void_p
    c.BIO_new_mem_buf.argtypes = [ctypes.c_void_p, ctypes.c_int]
    c.PEM_read_bio_X509.restype = ctypes.c_void_p
    c.PEM_read_bio_X509.argtypes = [ctypes.c_void_p] * 4
    c.PEM_read_bio_PrivateKey.restype = ctypes.c_void_p
    c.PEM_read_bio_PrivateKey.argtypes = [ctypes.c_void_p] * 4
    c.X509_digest.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
    c.X509_free.argtypes = [ctypes.c_void_p]
    c.EVP_PKEY_free.argtypes = [ctypes.c_void_p]
    c.EVP_sha256.restype = ctypes.c_void_p
    c.ERR_get_error.restype = ctypes.c_ulong
    c.ERR_error_string_n.argtypes = [ctypes.c_ulong, ctypes.c_char_p,
                                     ctypes.c_size_t]


def available() -> bool:
    """True when the system provides OpenSSL 3 shared libraries."""
    _load()
    return _ssl is not None


# libssl macro constants (ssl.h / dtls1.h, stable public ABI values)
_SSL_ERROR_WANT_READ = 2
_SSL_ERROR_WANT_WRITE = 3
_SSL_ERROR_ZERO_RETURN = 6
_SSL_VERIFY_PEER = 1
_SSL_VERIFY_FAIL_IF_NO_PEER_CERT = 2
_SSL_CTRL_SET_MTU = 17
_DTLS_CTRL_GET_TIMEOUT = 73
_DTLS_CTRL_HANDLE_TIMEOUT = 74
_SSL_CTRL_SET_MIN_PROTO_VERSION = 123
_SSL_OP_NO_QUERY_MTU = 0x00001000
_DTLS1_2_VERSION = 0xFEFD
_BIO_CTRL_PENDING = 10
_BIO_C_SET_BUF_MEM_EOF_RETURN = 130

_RECORD_HDR = 13  # type(1) version(2) epoch(2) seq(6) length(2)

# Keep the verify callback alive for the process lifetime (ctypes callbacks
# are garbage-collected otherwise and OpenSSL would call freed code). It is
# stateless (accept any chain; trust is the pinned fingerprint), so ONE
# callback serves every context — a per-endpoint callback appended to a list
# was an unbounded per-connection leak on a long-running server.
_VERIFY_CB_TYPE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_verify_cb = None
# DTLS_timer_cb: unsigned int (*)(SSL *, unsigned int timer_us)
_TIMER_CB_TYPE = ctypes.CFUNCTYPE(ctypes.c_uint, ctypes.c_void_p, ctypes.c_uint)


class DtlsError(Exception):
    pass


def _ssl_errors() -> str:
    buf = ctypes.create_string_buffer(256)
    out = []
    while True:
        code = _crypto.ERR_get_error()
        if not code:
            break
        _crypto.ERR_error_string_n(code, buf, 256)
        out.append(buf.value.decode(errors="replace"))
    return "; ".join(out) or "no error queue"


# --- identity ----------------------------------------------------------------


class DtlsIdentity:
    """Self-signed ECDSA P-256 certificate + key, as WebRTC endpoints use
    (libdatachannel generates the same on the fly). The SHA-256 certificate
    fingerprint is the trust anchor carried in signaling (SDP a=fingerprint,
    RFC 8122 format: uppercase hex pairs, colon-separated)."""

    def __init__(self, cert_pem: bytes, key_pem: bytes):
        self.cert_pem = cert_pem
        self.key_pem = key_pem
        self.fingerprint = _fingerprint_of_pem(cert_pem)
        self._ssl_ctx = None  # shared SSL_CTX, built lazily (one per identity)

    def __del__(self):  # free the shared context with the identity
        try:
            if getattr(self, "_ssl_ctx", None) and _ssl is not None:
                _ssl.SSL_CTX_free(self._ssl_ctx)
                self._ssl_ctx = None
        except Exception:
            pass

    @classmethod
    def generate(cls, common_name: str = "asciichat") -> "DtlsIdentity":
        try:
            return cls(*_gen_cert_cryptography(common_name))
        except ImportError:
            return cls(*_gen_cert_openssl_cli(common_name))


_default_identity: DtlsIdentity | None = None
_default_identity_lock = __import__("threading").Lock()


def default_identity() -> DtlsIdentity:
    """One cached per-process identity (what WebRTC stacks do per
    PeerConnection factory). Keygen + X.509 signing is milliseconds with
    the cryptography package but a blocking `openssl req` subprocess
    without it — generating per-agent would let an unauthenticated
    POST /webrtc/offer stream stall the event loop, and buys nothing:
    the trust anchor is the fingerprint in the signed signaling, not
    certificate uniqueness."""
    global _default_identity
    with _default_identity_lock:
        if _default_identity is None:
            _default_identity = DtlsIdentity.generate()
        return _default_identity


def _gen_cert_cryptography(cn: str) -> tuple[bytes, bytes]:
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=30))
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def _gen_cert_openssl_cli(cn: str) -> tuple[bytes, bytes]:
    """Fallback when the `cryptography` package is absent: the openssl CLI
    ships wherever libssl does."""
    with tempfile.TemporaryDirectory() as d:
        certf, keyf = os.path.join(d, "c.pem"), os.path.join(d, "k.pem")
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
             "ec_paramgen_curve:P-256", "-keyout", keyf, "-out", certf,
             "-days", "30", "-nodes", "-subj", f"/CN={cn}"],
            check=True, capture_output=True,
        )
        with open(certf, "rb") as f:
            cert_pem = f.read()
        with open(keyf, "rb") as f:
            key_pem = f.read()
    return cert_pem, key_pem


def _fingerprint_of_pem(cert_pem: bytes) -> str:
    _load()
    if _ssl is None:
        raise DtlsError(f"OpenSSL 3 unavailable: {_load_error}")
    bio = _crypto.BIO_new_mem_buf(cert_pem, len(cert_pem))
    x509 = _crypto.PEM_read_bio_X509(bio, None, None, None)
    _crypto.BIO_free(bio)
    if not x509:
        raise DtlsError(f"bad certificate PEM: {_ssl_errors()}")
    try:
        return _x509_fingerprint(x509)
    finally:
        _crypto.X509_free(x509)


def _x509_fingerprint(x509_ptr) -> str:
    buf = ctypes.create_string_buffer(64)
    n = ctypes.c_uint(0)
    if _crypto.X509_digest(x509_ptr, _crypto.EVP_sha256(), buf,
                           ctypes.byref(n)) != 1:
        raise DtlsError(f"X509_digest failed: {_ssl_errors()}")
    return ":".join(f"{b:02X}" for b in buf.raw[: n.value])


def _ctx_for_identity(identity: DtlsIdentity):
    """Build (once) and return the identity's shared SSL_CTX: min-version
    DTLS 1.2, certificate + key loaded, verify = require-any-cert. The
    context lives as long as the identity (freed in DtlsIdentity.__del__);
    SSL objects created from it hold their own reference."""
    global _verify_cb
    # double-checked under a lock: two threads building endpoints for one
    # identity both saw _ssl_ctx unset and leaked one SSL_CTX
    with _ctx_build_lock:
        return _ctx_for_identity_locked(identity)


_ctx_build_lock = threading.Lock()


def _ctx_for_identity_locked(identity: DtlsIdentity):
    global _verify_cb
    if identity._ssl_ctx:
        return identity._ssl_ctx
    ctx = _ssl.SSL_CTX_new(_ssl.DTLS_method())
    if not ctx:
        raise DtlsError(f"SSL_CTX_new: {_ssl_errors()}")
    try:
        _ssl.SSL_CTX_ctrl(ctx, _SSL_CTRL_SET_MIN_PROTO_VERSION,
                          _DTLS1_2_VERSION, None)
        bio = _crypto.BIO_new_mem_buf(identity.cert_pem,
                                      len(identity.cert_pem))
        x509 = _crypto.PEM_read_bio_X509(bio, None, None, None)
        _crypto.BIO_free(bio)
        bio = _crypto.BIO_new_mem_buf(identity.key_pem, len(identity.key_pem))
        pkey = _crypto.PEM_read_bio_PrivateKey(bio, None, None, None)
        _crypto.BIO_free(bio)
        if not x509 or not pkey:
            # free whichever parse SUCCEEDED before bailing (cert-ok/key-bad
            # leaked the X509 per connection attempt)
            if x509:
                _crypto.X509_free(x509)
            if pkey:
                _crypto.EVP_PKEY_free(pkey)
            raise DtlsError(f"bad identity PEM: {_ssl_errors()}")
        ok1 = _ssl.SSL_CTX_use_certificate(ctx, x509)
        ok2 = _ssl.SSL_CTX_use_PrivateKey(ctx, pkey)
        _crypto.X509_free(x509)
        _crypto.EVP_PKEY_free(pkey)
        if ok1 != 1 or ok2 != 1:
            raise DtlsError(f"identity rejected: {_ssl_errors()}")
        # Require a peer certificate but accept ANY chain: authentication is
        # the SHA-256 fingerprint against the (Ed25519-signed) signaling
        # blob, the WebRTC trust model (RFC 8827 §6.2) — not the Web PKI.
        if _verify_cb is None:
            _verify_cb = _VERIFY_CB_TYPE(lambda _preverify, _store_ctx: 1)
        _ssl.SSL_CTX_set_verify(
            ctx, _SSL_VERIFY_PEER | _SSL_VERIFY_FAIL_IF_NO_PEER_CERT,
            _verify_cb)
    except Exception:
        _ssl.SSL_CTX_free(ctx)
        raise
    identity._ssl_ctx = ctx
    return ctx


# --- endpoint ----------------------------------------------------------------


class DtlsEndpoint:
    """Sans-io DTLS 1.2 endpoint. Drive it:

        ep = DtlsEndpoint(identity, server=False)
        ep.start()                      # client: queues ClientHello
        for dg in ep.outgoing(): send(dg)
        ...
        ep.incoming(datagram)           # on every received datagram
        app = ep.read()                 # decrypted application messages
        for dg in ep.outgoing(): send(dg)
        if ep.handshake_complete: ...   # may flip after any incoming()

    `peer_fingerprint` is available once the handshake completes; the caller
    MUST compare it against the signaled fingerprint before trusting data.
    """

    def __init__(self, identity: DtlsIdentity, server: bool, mtu: int = 1200,
                 initial_timer_ms: int = 150):
        _load()
        if _ssl is None:
            raise DtlsError(f"OpenSSL 3 unavailable: {_load_error}")
        self.identity = identity
        self.server = server
        self.mtu = mtu
        self.handshake_complete = False
        self.closed = False
        self.peer_fingerprint: str | None = None

        # the SSL_CTX is shared per identity (the per-PeerConnection-factory
        # pattern): certificate/key load + PEM parse happen once, not per
        # connection, and SSL objects reference-count the context
        self._ctx = _ctx_for_identity(identity)

        self._ssl = _ssl.SSL_new(self._ctx)
        if not self._ssl:
            raise DtlsError(f"SSL_new: {_ssl_errors()}")
        self._rbio = _crypto.BIO_new(_crypto.BIO_s_mem())
        self._wbio = _crypto.BIO_new(_crypto.BIO_s_mem())
        # empty mem BIO must read as "retry", not EOF, or the record layer
        # would treat an empty queue as a closed transport
        _crypto.BIO_ctrl(self._rbio, _BIO_C_SET_BUF_MEM_EOF_RETURN, -1, None)
        _crypto.BIO_ctrl(self._wbio, _BIO_C_SET_BUF_MEM_EOF_RETURN, -1, None)
        _ssl.SSL_set_bio(self._ssl, self._rbio, self._wbio)  # takes ownership
        _ssl.SSL_set_options(self._ssl, _SSL_OP_NO_QUERY_MTU)
        _ssl.SSL_ctrl(self._ssl, _SSL_CTRL_SET_MTU, mtu, None)
        if initial_timer_ms:
            # OpenSSL's default initial flight-retransmit timer is 1 s —
            # sluggish for a real-time transport (WebRTC stacks start
            # around 150 ms). Exponential backoff preserved, capped at 3 s.
            init_us = int(initial_timer_ms * 1000)

            def _timer(_ssl_ptr, timer_us, _init=init_us):
                return _init if timer_us == 0 else min(timer_us * 2, 3_000_000)

            cb = _TIMER_CB_TYPE(_timer)
            self._timer_cb_ref = cb  # outlive the SSL object
            _ssl.DTLS_set_timer_cb(self._ssl, cb)
        if server:
            _ssl.SSL_set_accept_state(self._ssl)
        else:
            _ssl.SSL_set_connect_state(self._ssl)

    # -- datagram side --------------------------------------------------------
    def start(self) -> None:
        """Kick off the handshake (client queues its first flight)."""
        self._pump_handshake()

    def incoming(self, datagram: bytes) -> None:
        """Feed one received datagram; then collect outgoing()/read()."""
        if self.closed:
            return
        _crypto.BIO_write(self._rbio, datagram, len(datagram))
        self._pump_handshake()

    def outgoing(self) -> list[bytes]:
        """Drain queued DTLS records, packed into <=MTU datagrams with
        record boundaries respected (a record never splits across
        datagrams; flights coalesce)."""
        pending = _crypto.BIO_ctrl(self._wbio, _BIO_CTRL_PENDING, 0, None)
        if pending <= 0:
            return []
        buf = ctypes.create_string_buffer(pending)
        n = _crypto.BIO_read(self._wbio, buf, pending)
        raw = buf.raw[:n]
        # split into records, greedily pack
        out: list[bytes] = []
        cur = bytearray()
        at = 0
        while at + _RECORD_HDR <= len(raw):
            rec_len = _RECORD_HDR + int.from_bytes(raw[at + 11 : at + 13], "big")
            rec = raw[at : at + rec_len]
            at += rec_len
            if cur and len(cur) + len(rec) > self.mtu:
                out.append(bytes(cur))
                cur = bytearray()
            cur += rec
        if at < len(raw):  # trailing partial record: emit as-is (shouldn't happen)
            cur += raw[at:]
        if cur:
            out.append(bytes(cur))
        return out

    # -- handshake ------------------------------------------------------------
    def _pump_handshake(self) -> None:
        if self.handshake_complete or self.closed:
            return
        rc = _ssl.SSL_do_handshake(self._ssl)
        if rc == 1:
            self.handshake_complete = True
            self._capture_peer_fingerprint()
            return
        err = _ssl.SSL_get_error(self._ssl, rc)
        if err in (_SSL_ERROR_WANT_READ, _SSL_ERROR_WANT_WRITE):
            return
        raise DtlsError(f"handshake failed (err={err}): {_ssl_errors()}")

    def _capture_peer_fingerprint(self) -> None:
        x509 = _ssl.SSL_get1_peer_certificate(self._ssl)
        if not x509:
            raise DtlsError("handshake finished without a peer certificate")
        try:
            self.peer_fingerprint = _x509_fingerprint(x509)
        finally:
            _crypto.X509_free(x509)

    def timeout(self) -> float | None:
        """Seconds until the DTLS retransmission timer fires, or None."""

        class _Timeval(ctypes.Structure):
            _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]

        tv = _Timeval()
        if _ssl.SSL_ctrl(self._ssl, _DTLS_CTRL_GET_TIMEOUT, 0,
                         ctypes.byref(tv)) != 1:
            return None
        return tv.tv_sec + tv.tv_usec / 1e6

    def handle_timeout(self) -> None:
        """Retransmit the current flight if its timer expired; then drain
        outgoing()."""
        if not self.closed:
            _ssl.SSL_ctrl(self._ssl, _DTLS_CTRL_HANDLE_TIMEOUT, 0, None)

    # -- application data -----------------------------------------------------
    def write(self, data: bytes) -> None:
        """Queue one application datagram (one DTLS record; must fit the
        MTU after ~30-60 B of record overhead — the SCTP layer above
        fragments to stay inside it)."""
        if not self.handshake_complete:
            raise DtlsError("write before handshake completion")
        rc = _ssl.SSL_write(self._ssl, data, len(data))
        if rc != len(data):
            err = _ssl.SSL_get_error(self._ssl, rc)
            raise DtlsError(f"SSL_write rc={rc} err={err}: {_ssl_errors()}")

    def read(self) -> list[bytes]:
        """Drain decrypted application messages (one per DTLS record)."""
        out: list[bytes] = []
        if self.closed:
            return out
        buf = ctypes.create_string_buffer(self.mtu + 256)
        while True:
            rc = _ssl.SSL_read(self._ssl, buf, len(buf))
            if rc > 0:
                out.append(buf.raw[:rc])
                continue
            err = _ssl.SSL_get_error(self._ssl, rc)
            if err == _SSL_ERROR_ZERO_RETURN:  # close_notify
                self.closed = True
            elif err not in (_SSL_ERROR_WANT_READ, _SSL_ERROR_WANT_WRITE):
                # fatal alert / protocol error (SSL_ERROR_SSL): the peer's
                # stack died WITHOUT close_notify. Swallowing it left
                # closed=False, so the datachannel ghost-detection never
                # fired and recv() blocked forever.
                log.debug("DTLS read fatal (err %d): %s", err, _ssl_errors())
                self.closed = True
            break
        return out

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                _ssl.SSL_shutdown(self._ssl)  # queues close_notify in wbio
            except Exception:
                pass

    def __del__(self):  # best-effort native cleanup
        try:
            if getattr(self, "_ssl", None):
                _ssl.SSL_free(self._ssl)  # frees owned BIOs
                self._ssl = None
            # self._ctx is the identity's shared context — NOT freed here
            self._ctx = None
        except Exception:
            pass
