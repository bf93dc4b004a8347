"""P2P transport: ICE-lite connectivity + a NEGOTIATED channel stack
(the reference's WebRTC transport role, lib/network/webrtc/ +
libdatachannel).

- IceLiteAgent (RFC 8445 subset on net/stun.py): host/srflx candidate
  gathering, ufrag/pwd, STUN Binding connectivity checks with
  MESSAGE-INTEGRITY both ways, candidate-pair nomination — over ONE udp
  socket that then carries the application channel (RFC 7983
  demultiplexing).
- The channel PROTOCOL is negotiated per pair at nomination
  (`make_channel`): when both peers advertised a DTLS certificate
  fingerprint in the Ed25519-signed signaling blob, the pair carries real
  browser-grade WebRTC DataChannels — DTLS 1.2 + SCTP + DCEP
  (net/datachannel.py, net/dtls.py, net/sctp.py). Otherwise (older build,
  no OpenSSL, or `ASCIICHAT_P2P_DTLS=0`/`--p2p-dtls off`) it falls back
  to this module's legacy SecureP2PChannel: a reliable ordered byte
  stream (Go-Back-N ARQ: 1200-byte segments, cumulative acks, RTO
  retransmit) of XSalsa20-Poly1305 secretbox datagrams under the X25519
  session key from the signaling blob. ACIP packets flow unchanged inside
  either stack.

See docs/webrtc-design.md for the full connect ladder (direct -> relay)
and the browser signaling path. The port's copy of
``asciichat_tpu/net/webrtc.py``; it imports ``net/crypto`` (which needs
``cryptography``) only when an agent is made.
"""

from __future__ import annotations

import asyncio
import socket
import struct
import time
from typing import TYPE_CHECKING

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import stun
from asciichat_tpu_torch.utils.logsys import get_logger

if TYPE_CHECKING:
    from asciichat_tpu_torch.net.crypto import CryptoContext

log = get_logger("webrtc")

SEGMENT_SIZE = 1200  # stay under typical path MTU
RTO_S = 0.2
WINDOW = 64

# RFC 7675 consent freshness on the nominated pair (libdatachannel keeps
# the same keepalive/consent discipline on its agent,
# the reference's lib/network/webrtc/ice.c role): a STUN Binding request
# every CONSENT_INTERVAL_S; a valid response refreshes consent; no valid
# response for CONSENT_EXPIRY_S declares the pair dead (NAT rebind, path
# loss) and triggers re-nomination, then the relay fallback.
CONSENT_INTERVAL_S = 5.0
CONSENT_EXPIRY_S = 30.0
# must exceed the peer's CONSENT beat (5 s) with margin: the controlled
# side's only re-nomination stimulus after a one-sided consent death is the
# peer's next USE-CANDIDATE check, and a 4 s window expired BEFORE a healthy
# peer's next 5 s beat ~20% of the time, downgrading a recoverable direct
# path to the relay rung
RENOMINATE_TIMEOUT_S = 12.0

# Channel-stack default for new agents: "auto" upgrades to DTLS-SCTP
# DataChannels when OpenSSL 3 is present AND the peer advertises a
# fingerprint; ASCIICHAT_P2P_DTLS=0 pins the legacy secretbox stream
# (operator kill-switch; also how ARQ-specific tests stay deterministic).
import os as _os

DTLS_DEFAULT: bool | str = _os.environ.get("ASCIICHAT_P2P_DTLS", "auto")


def _rand_token(n: int = 8) -> str:
    import secrets

    return secrets.token_hex(n)


class IceLiteAgent(asyncio.DatagramProtocol):
    """One-socket ICE-lite agent + the reliable channel's datagram engine."""

    def __init__(self, controlling: bool, dtls: bool | str | None = None,
                 consent_interval: float = CONSENT_INTERVAL_S,
                 consent_expiry: float = CONSENT_EXPIRY_S,
                 renominate_timeout: float = RENOMINATE_TIMEOUT_S):
        self.controlling = controlling
        self.ufrag = _rand_token(3)
        self.pwd = _rand_token(11)
        # imported here, not with the module: net/crypto needs the
        # `cryptography` package, and a server without it must still start
        # (it then serves no WebRTC signaling: apps/webclient.WebRtcGateway)
        from asciichat_tpu_torch.net.crypto import CryptoContext

        self.crypto = CryptoContext()
        self.remote: dict | None = None
        self.peer_addr: tuple[str, int] | None = None
        self.connected = asyncio.Event()
        self.transport: asyncio.DatagramTransport | None = None
        self.channel = None  # SecureP2PChannel | DataChannelTransport
        self._check_task: asyncio.Task | None = None
        self._superseded = False  # relay fallback won; never nominate late
        self._srflx_waiters: dict[bytes, asyncio.Future] = {}
        self.srflx_candidate: dict | None = None
        # RFC 7675 consent freshness + re-nomination state
        self.consent_interval = consent_interval
        self.consent_expiry = consent_expiry
        self.renominate_timeout = renominate_timeout
        self.on_pair_failed = None  # callback: direct path dead, no new pair
        self._consent_task: asyncio.Task | None = None
        self._fail_task: asyncio.Task | None = None
        # insertion-ordered (dict) so the bound evicts the OLDEST txid —
        # set.pop() removes an arbitrary one, possibly the in-flight check's
        self._consent_txids: dict[bytes, None] = {}
        self._check_txids: dict[bytes, tuple] = {}
        self._pending_nominate = None
        self._last_consent = 0.0
        self.pair_deaths = 0  # consent expiries (observability)
        self.renominations = 0  # pairs re-nominated after a death
        self.prflx_promoted = 0  # peer-reflexive candidates learned
        # DTLS-SCTP DataChannel upgrade (browser-grade stack): advertise a
        # certificate fingerprint when OpenSSL is available; the channel
        # type is then negotiated — both sides advertise -> DataChannel,
        # else the legacy secretbox stream (mixed populations work).
        self.dtls_identity = None
        if dtls is None:
            dtls = DTLS_DEFAULT
        if isinstance(dtls, str):
            if dtls == "auto":
                from asciichat_tpu_torch.net import dtls as dtls_mod

                dtls = dtls_mod.available()
            else:
                dtls = dtls.lower() not in ("0", "false", "no", "off")
        if dtls:
            from asciichat_tpu_torch.net import dtls as dtls_mod

            # per-process cached identity: certificate generation must not
            # run per-agent on the event loop (unauthenticated offers would
            # make it a cheap stall), and WebRTC trust is the fingerprint
            # in the signed signaling, not cert uniqueness
            self.dtls_identity = dtls_mod.default_identity()

    # -- lifecycle -----------------------------------------------------------
    async def start(self, bind: str = "0.0.0.0", port: int = 0) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(bind, port)
        )
        # media-stream-sized socket buffers: a burst window of ~256 KB
        # must not overflow the ~212 KB Linux default rcvbuf while the
        # single-threaded receiver drains (drops there look like path
        # loss and trip congestion control for nothing)
        sock = self.transport.get_extra_info("socket")
        if sock is not None:
            for opt, name in ((socket.SO_RCVBUF, "rcvbuf"),
                              (socket.SO_SNDBUF, "sndbuf")):
                try:
                    sock.setsockopt(socket.SOL_SOCKET, opt, 1 << 20)
                    # the kernel silently clamps to net.core.{r,w}mem_max
                    # (212992 stock) — verify, or the protection is a
                    # no-op and burst drops masquerade as path loss
                    got = sock.getsockopt(socket.SOL_SOCKET, opt)
                    if got < (1 << 20):  # kernel reports 2x the set value
                        log.debug("SO_%s clamped to %d by net.core "
                                  "limits; large bursts may drop locally",
                                  name.upper(), got)
                except OSError:
                    pass

    @property
    def local_port(self) -> int:
        return self.transport.get_extra_info("sockname")[1]

    async def gather_srflx(self, stun_server: tuple[str, int],
                           timeout: float = 2.0) -> dict | None:
        """Server-reflexive candidate: one Binding request to a STUN server,
        XOR-MAPPED-ADDRESS is our public address (RFC 8445 §5.1.1; needed
        behind NATs UPnP can't open). Returns None when the server doesn't
        answer (zero-egress environments)."""
        txid = stun.new_transaction_id()
        req = stun.build(stun.BINDING_REQUEST, txid, [], password=None)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._srflx_waiters[txid] = fut
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:  # honor the DECLARED budget
                self.transport.sendto(req, stun_server)
                wait = min(0.5, max(0.05, deadline - time.monotonic()))
                try:
                    addr = await asyncio.wait_for(asyncio.shield(fut), wait)
                    return {"ip": addr[0], "port": addr[1], "type": "srflx"}
                except asyncio.TimeoutError:
                    continue
            return None
        finally:
            self._srflx_waiters.pop(txid, None)

    def local_description(self) -> dict:
        """The signaling blob (SDP-role analog, relayed via ACDS
        ACIP_WEBRTC_SDP): ICE credentials + host candidates + the session
        public key for the channel's X25519 exchange."""
        port = self.local_port
        ips = {"127.0.0.1"}
        s = None
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect(("10.255.255.255", 1))
            ips.add(s.getsockname()[0])
        except OSError:
            pass  # no route: loopback only
        finally:
            if s is not None:
                s.close()
        cands = [{"ip": ip, "port": port} for ip in sorted(ips)]
        if self.srflx_candidate:
            cands.append(self.srflx_candidate)
        desc = {
            "ufrag": self.ufrag,
            "pwd": self.pwd,
            "pubkey": self.crypto.public_key.hex(),
            "candidates": cands,
        }
        if self.dtls_identity is not None:
            # a=fingerprint role (RFC 8827 §6.2): rides the Ed25519-signed
            # signaling envelope, pins the DTLS certificate
            desc["dtls_fp"] = self.dtls_identity.fingerprint
        return desc

    def _use_dtls(self) -> bool:
        return (self.dtls_identity is not None and self.remote is not None
                and bool(self.remote.get("dtls_fp")))

    def make_channel(self, send_datagram, peername, via_relay: bool = False):
        """Build the negotiated channel type over an arbitrary datagram
        carrier: DTLS-SCTP DataChannel when both sides advertised
        fingerprints, else the legacy secretbox stream. Used for both the
        nominated ICE pair and the ACDS relay (TURN-role) carrier, so both
        ends always agree on the protocol regardless of which carrier wins."""
        if self._use_dtls():
            from asciichat_tpu_torch.net.datachannel import DataChannelTransport

            return DataChannelTransport(
                self.dtls_identity, send_datagram, peername,
                client=self.controlling,
                expected_fingerprint=self.remote.get("dtls_fp"),
                via_relay=via_relay,
            )
        return SecureP2PChannel(self.crypto, send_datagram, peername,
                                via_relay=via_relay)

    def set_remote(self, desc: dict) -> None:
        self.remote = desc
        if desc.get("pubkey"):
            self.crypto.compute_shared(bytes.fromhex(desc["pubkey"]))
            self.crypto.handshake_complete = True
        elif not self._use_dtls():
            # a peer without an X25519 key AND without a DTLS fingerprint
            # has no way to secure the channel — refuse up front
            raise ValueError("remote description has neither pubkey nor "
                             "dtls_fp; no secure channel possible")
        if self.controlling:
            self._start_checks()
        pending = getattr(self, "_pending_nominate", None)
        if pending is not None and self.peer_addr is None:
            self._pending_nominate = None
            self._nominate(pending)

    def _start_checks(self) -> None:
        if self._check_task is None or self._check_task.done():
            self._check_task = asyncio.get_running_loop().create_task(
                self._run_checks()
            )

    def add_remote_candidate(self, cand: dict) -> None:
        """Trickle ICE (RFC 8838): a candidate arriving AFTER the initial
        description joins the live check list — `_run_checks` re-reads the
        candidate list every pass, so a late host/srflx/prflx candidate is
        probed on the next 200 ms beat with no restart."""
        if self.remote is None or not cand.get("ip"):
            return
        known = {(c["ip"], c["port"]) for c in self.remote["candidates"]}
        if (cand["ip"], cand["port"]) in known:
            return
        if len(self.remote["candidates"]) >= 64:
            return  # bound the check fan-out (a full agent offers ~dozens)
        self.remote["candidates"].append(dict(cand))
        if self.controlling and not self.connected.is_set():
            self._start_checks()

    async def _run_checks(self) -> None:
        """Connectivity checks: STUN Binding to every remote candidate until
        one answers with a valid response (RFC 8445 §7, simplified: first
        valid pair is nominated via USE-CANDIDATE). The candidate list is
        re-read each pass (trickle + prflx promotion feed it live)."""
        username = f"{self.remote['ufrag']}:{self.ufrag}"
        remote_pwd = self.remote["pwd"].encode()
        for _attempt in range(25):  # ~5 s
            if self.connected.is_set() or self.transport is None:
                return
            self._check_txids.clear()  # one round outstanding at a time
            for cand in list(self.remote["candidates"]):
                txid = stun.new_transaction_id()
                self._check_txids[txid] = (cand["ip"], cand["port"])
                req = stun.make_binding_request(txid, username, remote_pwd,
                                                controlling=True)
                self.transport.sendto(req, (cand["ip"], cand["port"]))
            await asyncio.sleep(0.2)

    # -- RFC 7675 consent freshness -------------------------------------------
    def _start_consent(self) -> None:
        if self._consent_task is None or self._consent_task.done():
            self._consent_task = asyncio.get_running_loop().create_task(
                self._consent_loop()
            )

    async def _consent_loop(self) -> None:
        """Consent checks on the nominated pair: an ICE-credentialed Binding
        request every `consent_interval`; valid responses stamp
        `_last_consent`; a stamp older than `consent_expiry` means sustained
        loss or a NAT rebind — tear the pair down (`_pair_dead`)."""
        while (not self._superseded and self.transport is not None
               and self.peer_addr is not None):
            await asyncio.sleep(self.consent_interval)
            if (self._superseded or self.transport is None
                    or self.peer_addr is None):
                return
            if self.remote is None:
                # controlled side nominated from an early Binding request
                # before set_remote: no credentials to send checks with yet
                self._last_consent = time.monotonic()
                continue
            txid = stun.new_transaction_id()
            self._consent_txids[txid] = None
            if len(self._consent_txids) > 16:  # bound: drop OLDEST stale id
                del self._consent_txids[next(iter(self._consent_txids))]
            req = stun.make_binding_request(
                txid, f"{self.remote['ufrag']}:{self.ufrag}",
                self.remote["pwd"].encode(), controlling=self.controlling,
            )
            self.transport.sendto(req, self.peer_addr)
            if time.monotonic() - self._last_consent > self.consent_expiry:
                self._pair_dead()
                return

    def _pair_dead(self) -> None:
        """Nominated pair lost consent: un-nominate and try to repair —
        controlling side re-runs checks over every known candidate
        (including promoted prflx); controlled (ice-lite) side waits for the
        peer's checks to find us again. If nothing re-nominates within
        `renominate_timeout`, `on_pair_failed` fires (the session's cue to
        walk down to the ACDS relay rung)."""
        old = self.peer_addr
        self.pair_deaths += 1
        self.peer_addr = None
        self.connected.clear()
        self._consent_txids.clear()
        log.warning("ICE consent expired on pair %s; attempting "
                    "re-nomination", old)
        if self.controlling:
            self._start_checks()
        if self._fail_task is None or self._fail_task.done():
            self._fail_task = asyncio.get_running_loop().create_task(
                self._fail_after(self.renominate_timeout)
            )

    async def _fail_after(self, delay: float) -> None:
        await asyncio.sleep(delay)
        if (self.peer_addr is None and not self._superseded
                and self.on_pair_failed is not None):
            cb, self.on_pair_failed = self.on_pair_failed, None
            log.warning("ICE re-nomination failed; signaling pair failure")
            cb()

    # -- datagram dispatch ----------------------------------------------------
    def datagram_received(self, data: bytes, addr) -> None:
        if stun.is_stun(data):
            self._on_stun(data, addr)
        elif self.channel is not None:
            self.channel.on_datagram(data)

    def _on_stun(self, data: bytes, addr) -> None:
        try:
            msg_type, txid, attrs = stun.parse(data)
        except stun.StunError:
            return
        if msg_type == stun.BINDING_REQUEST:
            # requests to us are keyed with OUR password (RFC 5389 §10.1.2)
            if not stun.verify_integrity(data, self.pwd.encode()):
                log.warning("STUN request with bad integrity from %s", addr)
                return
            self.transport.sendto(
                stun.make_binding_response(txid, addr, self.pwd.encode()), addr
            )
            # peer-reflexive promotion (RFC 8445 §7.3.1.3): an authenticated
            # request from an address the peer never advertised (its NAT
            # mapping) becomes a checkable candidate — after a pair death,
            # re-nomination can target the address that actually works
            if self.remote is not None:
                cands = self.remote["candidates"]
                known = {(c["ip"], c["port"]) for c in cands}
                if addr[:2] not in known:
                    cands.append(
                        {"ip": addr[0], "port": addr[1], "type": "prflx"})
                    self.prflx_promoted += 1
                    log.info("promoted prflx candidate %s", addr)
                    # a port-churning NAT must not grow the list (and the
                    # post-death check spray) without bound: evict the
                    # oldest prflx entry, never an advertised candidate
                    if len(cands) > 24:
                        # evict the OLDEST prflx, EXCLUDING the entry just
                        # appended — with >=24 advertised candidates the
                        # just-promoted one was the only prflx, so the old
                        # loop deleted it immediately and promotion was a
                        # permanent no-op. Advertised candidates are never
                        # evicted (add_remote_candidate caps them at 64).
                        for i, c in enumerate(cands[:-1]):
                            if c.get("type") == "prflx":
                                del cands[i]
                                break
            # Nomination follows the CONTROLLING agent (RFC 8445 §7.3.1.5):
            # as the controlled/lite side, only a request carrying
            # USE-CANDIDATE nominates — a full agent (browser) probes many
            # pairs with ordinary checks first, and pinning the first
            # check's source address could pick a one-way-viable path while
            # ignoring the pair the browser actually nominates.
            if not self.controlling:
                if stun.ATTR_USE_CANDIDATE in attrs:
                    self._nominate(addr)
        elif msg_type == stun.BINDING_SUCCESS:
            waiter = self._srflx_waiters.get(txid)
            if waiter is not None:
                # answer to our srflx lookup (no ICE credentials on a public
                # STUN binding): deliver XOR-MAPPED-ADDRESS
                try:
                    mapped = stun.parse_xor_mapped_address(
                        attrs[stun.ATTR_XOR_MAPPED_ADDRESS])
                except (KeyError, stun.StunError):
                    return
                if not waiter.done():
                    waiter.set_result(mapped)
                self.srflx_candidate = {"ip": mapped[0], "port": mapped[1],
                                        "type": "srflx"}
                return
            if self.remote and stun.verify_integrity(
                data, self.remote["pwd"].encode()
            ):
                if txid in self._consent_txids:
                    # answer to OUR consent check: consent refreshed
                    self._consent_txids.pop(txid, None)
                    self._last_consent = time.monotonic()
                    return
                checked = self._check_txids.pop(txid, None)
                if checked is None:
                    # RFC 5389 §7.3.3: a response matching NO outstanding
                    # request is discarded. The old path nominated on ANY
                    # integrity-valid success — responses are signed with
                    # the static ICE password, so one captured response
                    # replayed from an attacker address used to move the
                    # live channel there (blackhole until consent repair).
                    log.debug("ignoring unsolicited BINDING_SUCCESS from %s",
                              addr)
                    return
                # nominate the pair WE CHECKED, not the datagram's source
                self._nominate(checked)

    def stop_ice(self) -> None:
        """Stop connectivity checks and release the UDP socket while keeping
        the session crypto alive (a relay-fallback channel keeps using
        `agent.crypto`). Prevents a LATE STUN response from nominating a
        second, unread channel after the relay rung has won, and stops the
        socket/probe-task leak on every fallback."""
        self._superseded = True
        for t in (self._check_task, self._consent_task, self._fail_task):
            if t:
                t.cancel()
        self._check_task = self._consent_task = self._fail_task = None
        if self.transport:
            self.transport.close()
            self.transport = None

    def _bind_pair(self, addr):
        """Shared carrier-bind stanza (nomination, re-nomination, and the
        controlled side's follow-the-move all need it; two hand-kept copies
        used to drift)."""
        self.peer_addr = addr
        self._last_consent = time.monotonic()
        sender = lambda enc, _t=self.transport, _a=addr: _t.sendto(enc, _a)  # noqa: E731
        return sender

    def _nominate(self, addr) -> None:
        if self._superseded:
            return
        if self.remote is None:
            # DEFER: nomination can legitimately beat set_remote (a fast
            # controlling peer's USE-CANDIDATE), but the channel protocol
            # (DTLS vs secretbox) and the shared key are unknown until the
            # remote description lands — building the channel now minted a
            # KEYLESS legacy channel that silently dropped every DTLS
            # datagram and was never upgraded. set_remote replays this.
            self._pending_nominate = addr
            return
        if self.peer_addr is not None:
            # Already nominated. The controlled side still follows the
            # controlling agent if it MOVES the nomination (USE-CANDIDATE
            # from a new source = its old path died on its side only):
            # swap the live channel's carrier to the new pair.
            if self.controlling or tuple(addr[:2]) == tuple(self.peer_addr[:2]):
                return
            sender = self._bind_pair(addr)
            if self.channel is not None:
                self.channel.rebind(sender, addr, via_relay=False)
            self.renominations += 1
            log.info("controlling peer moved nomination to %s", addr)
            return
        sender = self._bind_pair(addr)
        if self._fail_task is not None:
            self._fail_task.cancel()
            self._fail_task = None
        if self.channel is None:
            self.channel = self.make_channel(sender, peername=addr)
        else:
            # RE-nomination after a consent death: the application holds
            # the live channel — swap its carrier to the new pair; ARQ/
            # SCTP retransmit in-flight data with original sequence nums
            self.channel.rebind(sender, addr, via_relay=False)
            self.renominations += 1
        self.connected.set()
        self._start_consent()
        log.info("ICE pair nominated: %s (%s, %s)", addr,
                 "controlling" if self.controlling else "controlled",
                 "dtls-sctp" if self._use_dtls() else "secretbox")

    async def wait_connected(self, timeout: float = 10.0) -> "SecureP2PChannel":
        await asyncio.wait_for(self.connected.wait(), timeout)
        return self.channel

    def close(self) -> None:
        for t in (self._check_task, self._consent_task, self._fail_task):
            if t:
                t.cancel()
        if self.channel:
            self.channel.close()
        if self.transport:
            self.transport.close()


class SecureP2PChannel:
    """Reliable ordered encrypted byte stream over a datagram carrier,
    exposing the ACIP Transport interface (send/recv of typed packets).

    The carrier is pluggable (`send_datagram`): normally the nominated ICE
    UDP pair, but when connectivity checks fail the SAME channel runs over
    the ACDS signaling relay (the TURN rung of the reference's
    direct-TCP -> ICE -> TURN connect ladder, parallel_connect.c:1-321) —
    segments stay end-to-end encrypted, so the relay host is blind.

    Segment plaintext: u64 seq | u64 ack | u8 flags | payload (64-bit byte
    offsets: a u32 would overflow after 4 GiB ≈ 1.9 h of 5 Mbit/s video and
    kill the channel with a struct.error mid-call). Each segment is
    encrypted as one secretbox datagram (nonce||MAC||ct) under the ICE
    session's X25519 key, so an on-path attacker (including the TURN-role
    relay) can neither read nor forge segments or acks. Go-Back-N:
    cumulative acks, RTO retransmission."""

    HDR = struct.Struct(">QQB")
    FLAG_ACK_ONLY = 1
    # receive-side backpressure: past this, in-order data is refused (not
    # acked) so the sender's window fills and IT stalls instead of our
    # buffer growing without bound while the app drains slowly. Must exceed
    # MAX_PACKET_SIZE or a maximal packet could never complete.
    RCV_BUF_CAP = pkt.MAX_PACKET_SIZE + 64 * 1024

    def __init__(self, crypto: CryptoContext, send_datagram, peername,
                 via_relay: bool = False):
        self.crypto = crypto
        self._send_datagram = send_datagram
        self.peer = peername
        self.via_relay = via_relay
        self.snd_base = 0  # oldest unacked byte
        self.snd_next = 0
        self._inflight: list[tuple[int, bytes]] = []  # (seq, payload)
        self.rcv_next = 0
        self._rcv_buf = bytearray()
        self._ooo: dict[int, bytes] = {}  # out-of-order segments by seq
        self._recv_waiter: asyncio.Event = asyncio.Event()
        self._loop = asyncio.get_running_loop()
        self._send_tasks: set = set()
        self._retx_task = self._loop.create_task(self._retx_loop())
        # serializes send(): a window-full await yields mid-packet, and a
        # concurrent send interleaving its bytes at that offset corrupts
        # the byte stream permanently (CRC mismatch on the receiver)
        self._send_lock = asyncio.Lock()
        # Earliest-outstanding retransmission timer (the SCTP T3-rtx rule
        # this repo has twice gotten wrong): restarted ONLY when the head of
        # the in-flight queue changes (new head sent, or acks advanced past
        # the old head) — NEVER refreshed by new data sends or by ACK-only
        # traffic, either of which would starve retransmission of a lost
        # head under continuous traffic.
        self._t3_start = 0.0
        self.closed = False
        self.retransmits = 0
        # interface parity with DataChannelTransport: a secretbox channel
        # needs no post-nomination handshake, it is ready at birth
        self.ready = asyncio.Event()
        self.ready.set()
        self.failed: str | None = None

    async def wait_ready(self, timeout: float = 10.0) -> "SecureP2PChannel":
        return self

    def rebind(self, send_datagram, peername, via_relay: bool = True) -> None:
        """Swap the datagram carrier under a live channel (direct UDP ->
        ACDS relay, or old pair -> re-nominated pair after a consent death).
        Go-Back-N state is carrier-independent: unacked segments simply
        retransmit over the new carrier with their original sequence
        numbers, so a channel the application already holds keeps working
        across the switch."""
        self._send_datagram = send_datagram
        self.peer = peername
        self.via_relay = via_relay

    # -- sending ---------------------------------------------------------------
    def _send_segment(self, seq: int, payload: bytes, flags: int = 0) -> None:
        plain = self.HDR.pack(seq, self.rcv_next, flags) + payload
        self._send_datagram(self.crypto.encrypt(plain))

    async def send(self, ptype: int, payload: bytes = b"") -> None:
        data = pkt.pack_packet(ptype, payload)
        async with self._send_lock:  # one packet's bytes stay contiguous
            at = 0
            while at < len(data):
                while self.snd_next - self.snd_base > WINDOW * SEGMENT_SIZE:
                    if self.closed:
                        raise ConnectionError("P2P channel closed")
                    await asyncio.sleep(0.01)  # window full: wait for acks
                if self.closed:
                    raise ConnectionError("P2P channel closed")
                chunk = data[at : at + SEGMENT_SIZE]
                if not self._inflight:
                    self._t3_start = time.monotonic()  # new head outstanding
                self._inflight.append((self.snd_next, chunk))
                self._send_segment(self.snd_next, chunk)
                self.snd_next += len(chunk)
                at += len(chunk)

    def send_nowait(self, ptype: int, payload: bytes = b"", *,
                    byte_cap: int | None = None) -> bool:
        """Non-blocking enqueue with overload shedding. THREAD-SAFE like
        DataChannelTransport.send_nowait: the server's render/audio ticks
        call this from executor threads (the two channel types are
        negotiated interchangeably behind one transport surface), so
        off-loop callers marshal via call_soon_threadsafe."""
        if self.closed or self.snd_next - self.snd_base > WINDOW * SEGMENT_SIZE:
            return False  # shed load like the TCP transport's bounded queue
        # caller-declared latest-wins budget (TCP-transport contract):
        # outstanding unacked bytes stand in for queue depth here
        if byte_cap is not None and (
                self.snd_next - self.snd_base + len(payload) > byte_cap):
            return False
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not self._loop:
            try:
                self._loop.call_soon_threadsafe(self._spawn_send, ptype, payload)
            except RuntimeError:
                return False  # loop shut down under us
            return True
        self._spawn_send(ptype, payload)
        return True

    def _spawn_send(self, ptype: int, payload: bytes) -> None:
        if self.closed:
            return
        # strong refs + observed completion: asyncio keeps only weak refs
        # to tasks (a parked one is GC-bait), and an unobserved
        # ConnectionError from a post-close send was 'Task exception was
        # never retrieved' noise at teardown
        task = self._loop.create_task(self.send(ptype, payload))
        self._send_tasks.add(task)

        def _done(t, _tasks=self._send_tasks):
            _tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                log.debug("queued p2p send failed: %r", t.exception())

        task.add_done_callback(_done)

    async def _retx_loop(self) -> None:
        while not self.closed:
            await asyncio.sleep(RTO_S)
            if self._inflight and time.monotonic() - self._t3_start >= RTO_S / 2:
                seq, chunk = self._inflight[0]  # Go-Back-N: oldest first
                self._send_segment(seq, chunk)
                self._t3_start = time.monotonic()  # timer restarts on retx
                self.retransmits += 1

    # -- receiving ---------------------------------------------------------------
    def on_datagram(self, data: bytes) -> None:
        # REFLECTION guard: both directions share one symmetric key, so our
        # own datagrams would decrypt if bounced back — but they carry OUR
        # nonce prefix (session_id), which the peer never uses. (Duplicate
        # LEGITIMATE datagrams are fine: Go-Back-N dedups by sequence.)
        if data[:16] == self.crypto.session_id:
            return
        try:
            plain = self.crypto.decrypt(data)
        except ValueError:
            return  # forged/garbled
        if len(plain) < self.HDR.size:
            return
        seq, ack, flags = self.HDR.unpack(plain[: self.HDR.size])
        payload = plain[self.HDR.size :]
        # ack processing: drop fully-acked segments; the T3 timer restarts
        # ONLY when the head actually advances (earliest-outstanding rule) —
        # a no-progress ack must leave it running
        acked_head = False
        while self._inflight and self._inflight[0][0] + len(self._inflight[0][1]) <= ack:
            self._inflight.pop(0)
            acked_head = True
        if acked_head and self._inflight:
            self._t3_start = time.monotonic()
        self.snd_base = max(self.snd_base, ack)
        if flags & self.FLAG_ACK_ONLY:
            return
        if payload:
            if seq == self.rcv_next and len(self._rcv_buf) < self.RCV_BUF_CAP:
                self._rcv_buf += payload
                self.rcv_next += len(payload)
                while self.rcv_next in self._ooo:  # drain buffered successors
                    nxt = self._ooo.pop(self.rcv_next)
                    self._rcv_buf += nxt
                    self.rcv_next += len(nxt)
                self._recv_waiter.set()
            elif seq > self.rcv_next and len(self._ooo) < 4 * WINDOW:
                self._ooo[seq] = payload
            # ack everything contiguous (also re-acks duplicates; a segment
            # refused by the RCV_BUF_CAP backpressure is simply NOT acked —
            # the sender's window fills and it stalls until recv() drains)
            self._send_segment(self.snd_next, b"", flags=self.FLAG_ACK_ONLY)

    async def recv(self) -> tuple[int, bytes]:
        """Next ACIP packet from the stream (blocks until complete; raises
        ConnectionError once the channel is closed and drained)."""
        while True:
            if len(self._rcv_buf) >= pkt.HEADER_SIZE:
                # slice only the header: copying the whole buffer per wake
                # is O(n^2) while a multi-MB frame accumulates
                ptype, length, crc, _cid = pkt.unpack_header(
                    bytes(self._rcv_buf[: pkt.HEADER_SIZE]))
                if len(self._rcv_buf) >= pkt.HEADER_SIZE + length:
                    payload = bytes(
                        self._rcv_buf[pkt.HEADER_SIZE : pkt.HEADER_SIZE + length]
                    )
                    del self._rcv_buf[: pkt.HEADER_SIZE + length]
                    if not pkt.verify_payload(payload, crc):
                        raise ValueError("P2P packet CRC mismatch")
                    return ptype, payload
            if self.closed:
                raise ConnectionError("P2P channel closed")
            self._recv_waiter.clear()
            await self._recv_waiter.wait()

    @property
    def peername(self):
        return self.peer

    def close(self) -> None:
        self.closed = True
        self._retx_task.cancel()
        # unblock parked readers (they observe .closed and raise); a send()
        # stuck in the window-full loop observes .closed on its next poll
        self._recv_waiter.set()
