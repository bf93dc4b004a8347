"""Crypto handshake state machines + encrypted packet wrapping.

Flow parity with lib/crypto/handshake/{client,server}.c and packet.h:299-339:

  client -> CRYPTO_CAPABILITIES  {supported kex/auth/cipher}
  server -> CRYPTO_PARAMETERS    {chosen algorithms + sizes}
  server -> CRYPTO_KEY_EXCHANGE_INIT  {server_pubkey[32]}
  client -> CRYPTO_KEY_EXCHANGE_RESP  {client_pubkey[32]}
  server -> CRYPTO_AUTH_CHALLENGE     {nonce[32]}        (password mode)
  client -> CRYPTO_AUTH_RESPONSE      {HMAC-SHA256[32]}
  server -> CRYPTO_HANDSHAKE_COMPLETE
  (or client -> CRYPTO_NO_ENCRYPTION to proceed in plaintext)

After completion every packet is built as inner_header||payload, encrypted
(nonce||MAC||ct), and sent as PACKET_TYPE_ENCRYPTED (packet.c:486-505).
Rekeying: REKEY_REQUEST/RESPONSE with fresh ephemeral X25519 keys after 1M
packets or 1h (crypto.c:143-155, 1201-1203).
"""

from __future__ import annotations

import struct

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net.crypto import CryptoContext
from asciichat_tpu_torch.net.transport import Transport

# Algorithm ids (packet.h:1064-1068)
KEX_ALGO_X25519 = 0x01
AUTH_ALGO_NONE = 0x00
AUTH_ALGO_ED25519 = 0x02  # SSH identity auth (lib/crypto/ssh/)
AUTH_ALGO_GPG = 0x03  # OpenPGP identity auth (lib/crypto/gpg)
CIPHER_ALGO_XSALSA20_POLY1305 = 0x01

CAPABILITIES_STRUCT = struct.Struct(">BBB")  # kex, auth, cipher bitmasks
# crypto_parameters_packet_t (packet.h:981-1007), little-fields packed
PARAMETERS_STRUCT = struct.Struct(">BBBBHHHHBBB3s")


def pack_parameters(password_auth: bool) -> bytes:
    return PARAMETERS_STRUCT.pack(
        KEX_ALGO_X25519, AUTH_ALGO_NONE, CIPHER_ALGO_XSALSA20_POLY1305,
        1 if password_auth else 0,
        32, 0, 0, 32,  # kex pub size, auth pub, signature, shared secret
        24, 16, 32,  # nonce, mac, hmac sizes
        b"\0\0\0",
    )


_ephemeral_host_identity = None


def _fallback_host_identity():
    """ONE ephemeral host identity per process. Minting one per CONNECTION
    broke TOFU completely: the first client pinned key A, the next
    handshake presented key B, and every reconnect died as a 'possible
    MITM'. A per-process key keeps pins valid for the server's uptime;
    restarts still re-key (configure ASCIICHAT_HOST_KEY / --host-key for a
    persistent identity — this fallback exists so key-auth servers work at
    all without one)."""
    global _ephemeral_host_identity
    if _ephemeral_host_identity is None:
        from asciichat_tpu_torch.net import identity as _ident

        _ephemeral_host_identity = _ident.Identity()
    return _ephemeral_host_identity


class HandshakeError(ValueError):
    pass


def _require_host_proof(ptype, payload, host_challenge, ctx, known_hosts,
                        server_id):
    """Key-auth mode server authentication: the next packet MUST be
    CRYPTO_SERVER_AUTH_RESP carrying the Ed25519 host proof over our fresh
    challenge + the DH key; verify and (optionally) TOFU-pin it. Returns
    (None, None) when the proof consumed the packet (caller recvs the next
    one), never silently skips — an impostor accepting the client's
    signature without proving a host identity is the MITM this closes."""
    from asciichat_tpu_torch.net import knownhosts as kh

    P = pkt.PacketType
    if ptype == P.CRYPTO_AUTH_FAILED:
        return ptype, payload  # terminal checks will raise 'auth failed'
    if ptype != P.CRYPTO_SERVER_AUTH_RESP:
        raise HandshakeError(
            "server did not prove a host identity in key-auth mode — "
            "possible MITM (known_hosts.c role)")
    try:
        host_pub = kh.verify_host_proof(payload, host_challenge,
                                        ctx.shared_key)
    except kh.HostKeyError as e:
        raise HandshakeError(str(e)) from None
    if known_hosts is not None and server_id:
        try:
            known_hosts.check(server_id, host_pub)
        except kh.HostKeyError as e:
            raise HandshakeError(str(e)) from None
    return None, None


async def client_handshake(
    t: Transport, ctx: CryptoContext, password: str | None = None,
    encrypt: bool = True, ssh_identity=None, gpg_identity=None,
    known_hosts=None, server_id: str | None = None,
) -> bool:
    """Run the client side; returns True when encryption is active.
    `ssh_identity` (net/sshauth.SshIdentity) or `gpg_identity`
    (net/gpgauth.GpgIdentity) answer the challenge with a signature over
    challenge||shared_key instead of the password HMAC. In key mode the
    SERVER must authenticate too: it signs our fresh challenge with its
    persistent Ed25519 host key (net/knownhosts.py, the known_hosts.c
    role), which is TOFU-pinned per `server_id` in `known_hosts` when
    provided — password mode gets mutual auth from the HMAC exchange
    instead."""
    P = pkt.PacketType
    if not encrypt:
        await t.send(P.CRYPTO_NO_ENCRYPTION)
        return False
    auth_algo = (AUTH_ALGO_ED25519 if ssh_identity is not None
                 else AUTH_ALGO_GPG if gpg_identity is not None
                 else AUTH_ALGO_NONE)
    await t.send(
        P.CRYPTO_CAPABILITIES,
        CAPABILITIES_STRUCT.pack(KEX_ALGO_X25519, auth_algo,
                                 CIPHER_ALGO_XSALSA20_POLY1305),
    )
    ptype, payload = await t.recv()
    if ptype != P.CRYPTO_PARAMETERS:
        raise HandshakeError(f"expected CRYPTO_PARAMETERS, got {ptype}")
    # VALIDATE the negotiated parameters (handshake/client.c checks the
    # chosen algorithms + sizes): silently proceeding on X25519/XSalsa20
    # assumptions against a server that picked something else would fail
    # much later with opaque MAC errors instead of a clear handshake error
    if len(payload) < PARAMETERS_STRUCT.size:
        raise HandshakeError("short CRYPTO_PARAMETERS")
    (kex, _srv_auth, cipher, _pw, kex_pub_size, _auth_pub, _sig, shared_size,
     nonce_size, mac_size, _hmac, _pad) = PARAMETERS_STRUCT.unpack(
        payload[:PARAMETERS_STRUCT.size])
    if (kex != KEX_ALGO_X25519 or cipher != CIPHER_ALGO_XSALSA20_POLY1305
            or kex_pub_size != 32 or shared_size != 32
            or nonce_size != 24 or mac_size != 16):
        raise HandshakeError(
            f"unsupported crypto parameters (kex={kex} cipher={cipher} "
            f"sizes={kex_pub_size}/{shared_size}/{nonce_size}/{mac_size})")
    ptype, payload = await t.recv()
    if ptype != P.CRYPTO_KEY_EXCHANGE_INIT or len(payload) < 32:
        raise HandshakeError("bad KEY_EXCHANGE_INIT")
    ctx.compute_shared(payload[:32])
    await t.send(P.CRYPTO_KEY_EXCHANGE_RESP, ctx.public_key)

    ptype, payload = await t.recv()
    has_credentials = (password or ssh_identity is not None
                       or gpg_identity is not None)
    if has_credentials and ptype != P.CRYPTO_AUTH_CHALLENGE:
        # a client holding credentials must be CHALLENGED: a fake server
        # skipping authentication entirely is the cheapest MITM of all
        raise HandshakeError(
            "server skipped authentication despite credentials — possible MITM")
    if ptype == P.CRYPTO_AUTH_CHALLENGE:
        if ssh_identity is not None or gpg_identity is not None:
            import asyncio as _asyncio
            import os as _os

            # one flow for both key backends — the host-proof/TOFU steps
            # must never drift between them
            if ssh_identity is not None:
                from asciichat_tpu_torch.net import sshauth as _auth_mod

                cred = ssh_identity
            else:
                from asciichat_tpu_torch.net import gpgauth as _auth_mod

                cred = gpg_identity
            # off the event loop: agent-backed identities do blocking UNIX-
            # socket I/O with a 5 s timeout (SshAgent.sign / gpg CLI),
            # which would stall every other connection during auth
            resp = await _asyncio.get_running_loop().run_in_executor(
                None, _auth_mod.make_auth_response,
                cred, payload[:32], ctx.shared_key,
            )
            host_challenge = _os.urandom(32)
            await t.send(P.CRYPTO_AUTH_RESPONSE, resp + host_challenge)
            ptype, payload = await t.recv()
            ptype, payload = _require_host_proof(
                ptype, payload, host_challenge, ctx, known_hosts, server_id)
            if ptype is None:
                ptype, payload = await t.recv()
        else:
            if password and ctx.password_key is None:
                # the caller may have set it already; Argon2id costs a full
                # 64 MiB pass — never derive the same key twice per connect
                ctx.set_password(password)
            # HMAC keyed by the shared secret (crypto.c:1068), PLUS a client
            # challenge for MUTUAL authentication: the server must prove it
            # also knows the password (handshake/client.c:840-865 — a fake
            # server silently accepting the client is a MITM signature)
            client_challenge = ctx.make_challenge()
            await t.send(P.CRYPTO_AUTH_RESPONSE,
                         ctx.answer_challenge(payload[:32]) + client_challenge)
            ptype, payload = await t.recv()
            if ptype == P.CRYPTO_SERVER_AUTH_RESP:
                if not ctx.verify_challenge_answer(payload[:32]):
                    raise HandshakeError(
                        "server authentication failed — possible MITM "
                        "(handshake/client.c:856)")
                ptype, payload = await t.recv()
            elif ptype != P.CRYPTO_AUTH_FAILED:
                raise HandshakeError(
                    "server skipped mutual authentication — possible MITM")
            # falls through to the shared terminal checks below
    if ptype == P.CRYPTO_AUTH_FAILED:
        raise HandshakeError("authentication failed")
    if ptype != P.CRYPTO_HANDSHAKE_COMPLETE:
        raise HandshakeError(f"expected HANDSHAKE_COMPLETE, got {ptype}")
    ctx.handshake_complete = True
    return True


async def server_handshake(
    t: Transport, ctx: CryptoContext, first_packet: tuple[int, bytes],
    require_auth: bool = False, allowed_keys=None, gpg_keyring=None,
    host_identity=None,
) -> bool:
    """Run the server side starting from the client's first crypto packet.
    `allowed_keys` (net/sshauth.AuthorizedKeys) enables SSH-identity auth:
    the challenge answer must be an Ed25519 signature by a whitelisted key
    (handshake/server.c:331 client_whitelist)."""
    P = pkt.PacketType
    ptype, payload = first_packet
    require_auth = require_auth or allowed_keys is not None or gpg_keyring is not None
    if ptype == P.CRYPTO_NO_ENCRYPTION:
        if require_auth:
            # No plaintext downgrade when authentication is required
            # (lib/crypto/handshake/server.c:177-189).
            raise HandshakeError("client requested no encryption but auth is required")
        return False
    if ptype == P.CRYPTO_CLIENT_HELLO:
        ptype, payload = await t.recv()
    if ptype != P.CRYPTO_CAPABILITIES:
        raise HandshakeError(f"expected CRYPTO_CAPABILITIES, got {ptype}")
    client_auth_algo = payload[1] if len(payload) >= 2 else AUTH_ALGO_NONE
    await t.send(P.CRYPTO_PARAMETERS, pack_parameters(require_auth))
    await t.send(P.CRYPTO_KEY_EXCHANGE_INIT, ctx.public_key)
    ptype, payload = await t.recv()
    if ptype != P.CRYPTO_KEY_EXCHANGE_RESP or len(payload) < 32:
        raise HandshakeError("bad KEY_EXCHANGE_RESP")
    ctx.compute_shared(payload[:32])

    if require_auth:
        challenge = ctx.make_challenge()
        await t.send(P.CRYPTO_AUTH_CHALLENGE, challenge)
        ptype, payload = await t.recv()
        ok = False
        if ptype == P.CRYPTO_AUTH_RESPONSE:
            if (allowed_keys is not None
                    and client_auth_algo == AUTH_ALGO_ED25519):
                from asciichat_tpu_torch.net import sshauth

                ok = sshauth.verify_auth_response(
                    payload, challenge, ctx.shared_key, allowed_keys
                )
            elif (gpg_keyring is not None
                    and client_auth_algo == AUTH_ALGO_GPG):
                import asyncio as _asyncio

                from asciichat_tpu_torch.net import gpgauth

                # gpg is a subprocess: never block the event loop on it
                ok = await _asyncio.get_running_loop().run_in_executor(
                    None, gpgauth.verify_auth_response,
                    payload, challenge, ctx.shared_key, gpg_keyring,
                )
            elif ctx.password_key is not None:
                ok = ctx.verify_challenge_answer(payload[:32])
        if not ok:
            await t.send(P.CRYPTO_AUTH_FAILED, b"authentication failed")
            raise HandshakeError("client failed authentication")
        if (client_auth_algo in (AUTH_ALGO_ED25519, AUTH_ALGO_GPG)
                and len(payload) >= 32):
            # key mode: prove OUR host identity over the client's trailing
            # challenge (net/knownhosts.py; known_hosts.c role). Without a
            # configured identity an ephemeral one still binds this session.
            from asciichat_tpu_torch.net import knownhosts as kh

            hid = host_identity or _fallback_host_identity()
            await t.send(P.CRYPTO_SERVER_AUTH_RESP,
                         kh.sign_host_proof(hid, payload[-32:],
                                            ctx.shared_key))
        if (ctx.password_key is not None and len(payload) >= 64
                and client_auth_algo == AUTH_ALGO_NONE):
            # MUTUAL auth: answer the client's challenge so a fake server
            # can't silently accept (handshake/server.c:613-628)
            await t.send(P.CRYPTO_SERVER_AUTH_RESP,
                         ctx.answer_challenge(payload[32:64]))
    await t.send(P.CRYPTO_HANDSHAKE_COMPLETE)
    ctx.handshake_complete = True
    return True


class SecureChannel:
    """Encrypt/decrypt packets over a Transport after handshake completion.

    Outgoing: inner = header(22)||payload encrypted into PACKET_TYPE_ENCRYPTED.
    Incoming: ENCRYPTED packets are unwrapped to (inner_type, inner_payload);
    handshake-range packets (1000-1299) stay plaintext (packet.h:304).
    Initiates rekeying transparently at the thresholds.
    """

    def __init__(self, t: Transport, ctx: CryptoContext, initiator: bool):
        self.t = t
        self.ctx = ctx
        self.initiator = initiator
        # anti-replay: per-sender-nonce-prefix sliding WINDOW (highest
        # counter + 64-bit seen-bitmap, the IPsec/DTLS shape). Not a
        # strictly-increasing check: counters are allocated at _wrap time
        # in the CALLING thread, but cross-thread send_nowait enqueues are
        # marshalled onto the loop via call_soon_threadsafe, so two
        # legitimate packets can reach the ordered transport with their
        # counters swapped (executor render tick vs loop-thread PONG) — a
        # strict check tore down healthy sessions as 'replayed'. The
        # window accepts bounded reordering while still rejecting every
        # DUPLICATE and anything older than 64 counters. Rekeys change the
        # prefix (fresh entry); entries only appear after a successful
        # decrypt, so the dict is bounded by rekey count.
        self._recv_win: dict[bytes, tuple[int, int]] = {}
        # rekey decision lock: send() (loop thread) and send_nowait()
        # (executor threads) both run the needs_rekey/in_progress
        # check-then-start — unsynchronized, two threads could both pass
        # and double-start, leaving _temp_private holding the SECOND
        # ephemeral key while the (rate-limited) peer answers the FIRST:
        # the initiator commits a key the peer doesn't have and the
        # session tears down on the next packet
        import threading

        self._rekey_lock = threading.Lock()

    def _maybe_start_rekey(self) -> bytes | None:
        """Atomically decide whether a rekey is due and start it; returns
        the REKEY_REQUEST body to send, or None."""
        if not self.initiator:
            return None
        with self._rekey_lock:
            if self.ctx.rekey_stalled():
                # a lost/rate-limited REKEY_RESPONSE must not latch
                # in_progress forever and silently disable the
                # forward-security thresholds
                self.ctx.abandon_rekey()
            if self.ctx.needs_rekey() and not self.ctx.rekey.in_progress:
                return self.ctx.start_rekey()
        return None

    def _wrap(self, ptype: int, payload: bytes) -> bytes:
        inner = pkt.pack_packet(ptype, payload)
        return self.ctx.encrypt(inner)

    def _unwrap(self, blob: bytes) -> tuple[int, bytes]:
        if len(blob) < 24:
            raise ValueError("short encrypted packet")
        sid, ctr = blob[:16], int.from_bytes(blob[16:24], "big")
        # REFLECTION: both directions share one symmetric key, so our own
        # recorded ciphertext would decrypt if bounced back — but it carries
        # OUR nonce prefix, which a legitimate peer never uses
        if sid == self.ctx.session_id or sid == self.ctx.previous_session_id:
            raise ValueError("reflected packet (own nonce prefix)")
        inner = self.ctx.decrypt(blob)
        # REPLAY: sliding window per sender prefix (checked only after
        # authentication succeeds)
        hi, bits = self._recv_win.get(sid, (0, 0))
        if ctr > hi:
            shift = ctr - hi
            bits = ((bits << shift) | 1) & ((1 << 64) - 1) if shift < 64 else 1
            hi = ctr
        else:
            off = hi - ctr
            if off >= 64:
                raise ValueError(
                    f"replayed encrypted packet (counter {ctr} too old, "
                    f"window at {hi})")
            if bits & (1 << off):
                raise ValueError(
                    f"replayed encrypted packet (counter {ctr} duplicate)")
            bits |= 1 << off
        self._recv_win[sid] = (hi, bits)
        ptype, length, crc, _cid = pkt.unpack_header(inner)
        payload = inner[pkt.HEADER_SIZE : pkt.HEADER_SIZE + length]
        if not pkt.verify_payload(payload, crc):
            raise ValueError("inner packet CRC mismatch")
        return ptype, payload

    async def send(self, ptype: int, payload: bytes = b"") -> None:
        req = self._maybe_start_rekey()
        if req is not None:
            # rekey messages travel INSIDE the encrypted channel: an on-path
            # attacker without the current session key can neither inject a
            # request nor read the response's ephemeral key (a plaintext
            # exchange would let an active attacker swap in a DH pair it
            # knows and take over the session)
            await self.t.send(
                pkt.PacketType.ENCRYPTED,
                self._wrap(pkt.PacketType.CRYPTO_REKEY_REQUEST, req),
            )
        await self.t.send(pkt.PacketType.ENCRYPTED, self._wrap(ptype, payload))

    def send_nowait(self, ptype: int, payload: bytes = b"", *,
                    byte_cap: int | None = None) -> bool:
        # the rekey thresholds must gate THIS path too: all steady-state
        # traffic (frames, audio, keepalive) flows through send_nowait, so
        # checking only in send() made the 1M-packet/1-hour forward-security
        # rekey effectively unreachable in a real session
        req = self._maybe_start_rekey()
        if req is not None:
            self.t.send_nowait(
                pkt.PacketType.ENCRYPTED,
                self._wrap(pkt.PacketType.CRYPTO_REKEY_REQUEST, req),
            )
        return self.t.send_nowait(pkt.PacketType.ENCRYPTED,
                                  self._wrap(ptype, payload),
                                  byte_cap=byte_cap)

    async def recv(self) -> tuple[int, bytes]:
        P = pkt.PacketType
        while True:
            ptype, payload = await self.t.recv()
            if ptype == P.ENCRYPTED:
                inner_type, inner = self._unwrap(payload)
                if inner_type == P.CRYPTO_REKEY_REQUEST:
                    # authenticated (it decrypted under the session key):
                    # respond in-channel, hold the new key PENDING until the
                    # peer proves possession (the REKEY_COMPLETE proof or an
                    # overtaking data packet). Rate-limited regardless.
                    if len(inner) < 32 or not self.ctx.allow_incoming_rekey():
                        continue
                    resp = self.ctx.respond_rekey(inner[:32])
                    await self.t.send(
                        P.ENCRYPTED, self._wrap(P.CRYPTO_REKEY_RESPONSE, resp)
                    )
                    continue
                if inner_type == P.CRYPTO_REKEY_RESPONSE:
                    try:
                        # under _rekey_lock: an executor-thread send_nowait
                        # can abandon_rekey()/start_rekey() concurrently —
                        # unlocked, _temp_private could be nulled between
                        # finish_rekey's check and the DH (AttributeError
                        # out of recv) or replaced so a LATE response for
                        # the abandoned request commits a key the responder
                        # never computed (the echo check catches that too)
                        with self._rekey_lock:
                            self.ctx.finish_rekey(inner)
                    except ValueError:
                        continue  # unsolicited/stale response: ignore, don't die
                    # Proof-of-possession: a marker encrypted under the NEW
                    # key; the responder commits only once this decrypts
                    # (crypto.c:1225).
                    await self.t.send(
                        P.CRYPTO_REKEY_COMPLETE, self.ctx.encrypt(b"REKEY-OK")
                    )
                    continue
                return inner_type, inner
            if ptype in (P.CRYPTO_REKEY_REQUEST, P.CRYPTO_REKEY_RESPONSE):
                # PLAINTEXT rekey messages are exactly the injection vector
                # the in-channel exchange closes: drop them.
                continue
            if ptype == P.CRYPTO_REKEY_COMPLETE:
                try:
                    self.ctx.decrypt(payload)  # commits the pending key
                except ValueError:
                    pass  # forged/garbled proof: keep the current key
                continue
            if 1000 <= ptype <= 1299:
                continue  # stray plaintext handshake chatter: ignore
            # Anything else arriving in PLAINTEXT after encryption was
            # established is an injection attempt: an on-path attacker can
            # frame arbitrary unencrypted packets, and silently returning
            # them here would hand them to the application as authenticated
            # traffic (integrity bypass). Violate loudly -> disconnect.
            raise ValueError(
                f"plaintext packet type {ptype} inside an encrypted session")

    async def close(self) -> None:
        await self.t.close()

    @property
    def peername(self):
        return self.t.peername
