"""WebRTC DataChannel transport: ACIP over DTLS + SCTP on a datagram carrier.

This is the browser-grade stack of the reference's WebRTC transport
(lib/network/webrtc/webrtc.c + libdatachannel: ICE -> DTLS -> SCTP ->
DataChannel), assembled from this framework's sans-io pieces:

    IceLiteAgent (net/webrtc.py)  — nominates the UDP pair, owns the socket
    DtlsEndpoint (net/dtls.py)    — OpenSSL DTLS 1.2, fingerprint-pinned
    SctpAssociation (net/sctp.py) — reliability, ordering, DCEP channel

Framing: one SCTP user message (PPID 53, WebRTC binary) carries exactly one
ACIP wire packet (header + CRC + payload, net/packet.py) — the same bytes
the TCP/WebSocket transports move, so everything above the transport
(dispatcher, handlers, frames, audio) runs unchanged over a DataChannel.

Trust model: the certificate fingerprints ride the Ed25519-signed signaling
blobs (the WebRTC a=fingerprint role, RFC 8827 §6.2); after the DTLS
handshake the peer's actual certificate digest MUST equal the signaled one
or the transport self-destructs before any application byte flows.

The carrier is pluggable exactly like SecureP2PChannel's: normally the
nominated ICE pair, but `rebind()` can swap it for the ACDS relay (TURN
role) — DTLS is carrier-agnostic and SCTP retransmits anything in flight,
so an established channel survives the fallback.

The port's copy of ``asciichat_tpu/net/datachannel.py``.
"""

from __future__ import annotations

import asyncio

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import sctp as sctp_mod
from asciichat_tpu_torch.net.dtls import DtlsEndpoint, DtlsError, DtlsIdentity
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("datachannel")

# Soft send backpressure: cap on SCTP bytes queued+in flight before send()
# yields (the TCP transport's bounded-send-queue analog)
_SEND_BUF_CAP = 1 << 20


class DataChannelTransport:
    """ACIP transport over DTLS-SCTP. Same surface as SecureP2PChannel:
    send/send_nowait/recv/close/peername/rebind + `wait_ready()` (the DTLS
    and SCTP handshakes happen after ICE nomination)."""

    def __init__(self, identity: DtlsIdentity, send_datagram, peername, *,
                 client: bool, expected_fingerprint: str | None,
                 via_relay: bool = False):
        self.identity = identity
        self._send_datagram = send_datagram
        self.peer = peername
        self.client = client
        self.expected_fingerprint = expected_fingerprint
        self.via_relay = via_relay
        self.closed = False
        self._closing = False  # _close_sync in progress (farewell drain)
        self.failed: str | None = None
        self.ready = asyncio.Event()
        self.retransmits = 0  # interface parity; SCTP tracks per-chunk

        self.dtls = DtlsEndpoint(identity, server=not client)
        self.sctp = sctp_mod.SctpAssociation(self._sctp_out, client=client)
        self.sctp.on_message = self._on_sctp_message
        self.sctp.on_established = self._on_sctp_established
        self.sctp.on_closed = self._on_sctp_closed
        self.sctp.on_channel_open = lambda sid, label: self.ready.set()
        self.sctp.on_channel_acked = lambda sid: self.ready.set()
        self._sctp_started = False
        self._rx: asyncio.Queue[tuple[int, bytes]] = asyncio.Queue()
        self._loop = asyncio.get_running_loop()
        self._timer_task = self._loop.create_task(self._timers())
        if client:
            self.dtls.start()
            self._drain_dtls()

    # -- carrier side ---------------------------------------------------------
    def on_datagram(self, data: bytes) -> None:
        """Feed one datagram from the carrier (ICE socket or relay)."""
        if self.closed:
            return
        try:
            self.dtls.incoming(data)
        except DtlsError as e:
            self._fail(f"DTLS failure: {e}")
            return
        if self.dtls.handshake_complete and not self._sctp_started:
            self._start_sctp()
        for msg in self.dtls.read():
            self.sctp.on_packet(msg)
        if self.dtls.closed and not self.closed:
            # peer's close_notify: with nothing in flight the SCTP
            # no-progress abort never arms, so without observing this the
            # remote clean close would go undetected forever (recv() blocks,
            # the server keeps a ghost client)
            self._peer_closed()
            return
        self._drain_dtls()

    def rebind(self, send_datagram, peername, via_relay: bool = True) -> None:
        """Swap the datagram carrier (direct UDP -> ACDS relay, or a
        re-nominated ICE pair after consent loss). DTLS doesn't bind to
        addresses and SCTP retransmits in-flight chunks, so the channel —
        even mid-handshake — continues over the new carrier."""
        self._send_datagram = send_datagram
        self.peer = peername
        self.via_relay = via_relay
        # nudge retransmission onto the new carrier immediately
        self.dtls.handle_timeout()
        self._drain_dtls()

    def _drain_dtls(self) -> None:
        for dg in self.dtls.outgoing():
            try:
                self._send_datagram(dg)
            except Exception as e:  # carrier died mid-write
                self._fail(f"carrier send failed: {e}")
                return

    def _start_sctp(self) -> None:
        self._sctp_started = True
        got = self.dtls.peer_fingerprint
        if self.expected_fingerprint and got != self.expected_fingerprint:
            # signaling said one certificate, the wire presented another:
            # MITM between ICE and DTLS — kill the transport before data
            self._fail("DTLS certificate fingerprint mismatch "
                       f"(signaled {self.expected_fingerprint[:16]}..., "
                       f"got {(got or '?')[:16]}...)")
            return
        log.info("DTLS established with %s (fp %s...)", self.peer,
                 (got or "?")[:23])
        if self.client:
            self.sctp.connect()
            self._drain_dtls()

    def _on_sctp_established(self) -> None:
        if self.client:
            self._dc_sid = self.sctp.open_channel(label="acip")
        else:
            self.ready.set()  # server side: usable once the association is up
        self._drain_dtls()

    def _on_sctp_closed(self, reason: str) -> None:
        if not self.closed:
            self._fail(f"SCTP closed: {reason}")

    def _on_sctp_message(self, sid: int, ppid: int, data: bytes) -> None:
        try:
            ptype, length, crc, _cid = pkt.unpack_header(data)
            payload = data[pkt.HEADER_SIZE : pkt.HEADER_SIZE + length]
            if len(payload) != length or not pkt.verify_payload(payload, crc):
                raise ValueError("length/CRC mismatch")
        except Exception as e:
            log.warning("bad ACIP packet on DataChannel: %s", e)
            return
        self._rx.put_nowait((ptype, payload))

    # -- SCTP -> DTLS ---------------------------------------------------------
    def _sctp_out(self, packet_bytes: bytes) -> None:
        if self.closed or not self.dtls.handshake_complete:
            return
        try:
            self.dtls.write(packet_bytes)
        except DtlsError as e:
            self._fail(f"DTLS write failed: {e}")
            return
        self._drain_dtls()

    # -- ACIP surface ---------------------------------------------------------
    async def wait_ready(self, timeout: float = 10.0) -> "DataChannelTransport":
        """Wait for DTLS + SCTP + DCEP to complete over the nominated pair."""
        await asyncio.wait_for(self.ready.wait(), timeout)
        if self.failed:
            raise ConnectionError(self.failed)
        return self

    def _buffered(self) -> int:
        st = self.sctp
        try:
            return (sum(len(e[0]) for e in st._outstanding.values())
                    + sum(16 + len(q[4]) for q in st._send_queue))
        except RuntimeError:
            # dict mutated by the loop thread while an executor tick reads
            # the size for its drop decision — any approximation is fine
            return 0

    async def send(self, ptype: int, payload: bytes = b"") -> None:
        if self.failed or self.closed:
            # closed must raise like failed: after a clean local close()
            # _sctp_out drops everything, so a "successful" send here
            # would silently black-hole the packet (send_nowait already
            # returns False in this state — the two paths must agree)
            raise ConnectionError(self.failed or "channel closed")
        while self._buffered() > _SEND_BUF_CAP:
            if self.closed or self.failed:
                raise ConnectionError(self.failed or "channel closed")
            await asyncio.sleep(0.01)
        self.sctp.send(0 if self.client else self._peer_sid(),
                       sctp_mod.PPID_BINARY, pkt.pack_packet(ptype, payload))

    def _peer_sid(self) -> int:
        # server sends on the stream the client's DCEP opened (0); if none
        # yet, 0 is still correct for the single-channel ACIP case
        return 0

    def send_nowait(self, ptype: int, payload: bytes = b"", *,
                    byte_cap: int | None = None) -> bool:
        """Non-blocking enqueue with overload shedding.

        THREAD-SAFE like the TCP/WS transports: the server's render/audio
        ticks call this from executor threads, but the whole SCTP+DTLS
        stack is loop-affine — a foreign-thread SSL_write racing the loop
        thread's SSL_read corrupts OpenSSL's cipher state (observed:
        'Provider routines::cipher operation failed' killing the channel
        seconds into a soak). Off-loop callers marshal via
        call_soon_threadsafe; the buffered-size check there is a benign
        approximation for the drop decision."""
        if self.closed or self.failed or self._buffered() > _SEND_BUF_CAP:
            return False  # shed load like the TCP transport's bounded queue
        # caller-declared latest-wins budget (same contract as the TCP
        # transport): bulky payloads shed once the SCTP send buffer already
        # holds more than byte_cap of unflushed data
        if byte_cap is not None and self._buffered() + len(payload) > byte_cap:
            return False
        data = pkt.pack_packet(ptype, payload)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not self._loop:
            try:
                self._loop.call_soon_threadsafe(self._send_on_loop, data)
            except RuntimeError:
                return False  # loop shut down
            return True
        self._send_on_loop(data)
        return True

    def _send_on_loop(self, data: bytes) -> None:
        if self.closed or self.failed:
            return
        try:
            self.sctp.send(0, sctp_mod.PPID_BINARY, data)
        except Exception as e:
            self._fail(f"send failed: {e}")

    async def recv(self) -> tuple[int, bytes]:
        while True:
            if (self.failed or self.closed) and self._rx.empty():
                # closed without failure (clean local close()) must also
                # terminate the loop, or a concurrent recv() task spins on
                # 0.5 s timeouts forever
                raise ConnectionError(self.failed or "channel closed")
            try:
                return await asyncio.wait_for(self._rx.get(), 0.5)
            except asyncio.TimeoutError:
                continue

    @property
    def peername(self):
        return self.peer

    # -- lifecycle ------------------------------------------------------------
    async def _timers(self) -> None:
        try:
            while not self.closed:
                await asyncio.sleep(0.05)
                # DTLSv1_handle_timeout retransmits only if the flight timer
                # actually expired; safe to poll
                self.dtls.handle_timeout()
                self.sctp.tick()
                self._drain_dtls()
        except asyncio.CancelledError:
            pass

    def _fail(self, reason: str) -> None:
        if self.failed is None:
            self.failed = reason
            log.warning("DataChannel failed: %s", reason)
        self.ready.set()  # unblock waiters; wait_ready raises
        self.close()

    def _peer_closed(self) -> None:
        """Remote clean close (DTLS close_notify): not a failure, but recv()
        and wait_ready() must still unblock with ConnectionError."""
        if self.failed is None:
            self.failed = "closed by peer"
            log.info("DataChannel closed by peer %s", self.peer)
        self.ready.set()
        self.close()

    def close(self):
        """Close the channel. Callable from sync code (P2P paths) AND
        awaitable (the server's `await transport.close()` path): the work
        happens synchronously, the return value is an await-compatible
        no-op."""
        self._close_sync()
        return _Awaitable()

    def _close_sync(self) -> None:
        if self.closed or self._closing:
            return
        # farewell first, THEN flip self.closed: _sctp_out drops all SCTP
        # output once closed is set, so setting it before sctp.shutdown()
        # silently discarded the SHUTDOWN chunk (the peer never learned of
        # the close and kept a ghost association). _closing guards against
        # re-entry if the farewell drain itself fails into _fail()->close().
        self._closing = True
        try:
            if self.sctp.state == "established":
                self.sctp.shutdown()
            self.dtls.close()
        except Exception:
            pass
        self.closed = True
        self._drain_dtls_best_effort()
        self._timer_task.cancel()
        owner = getattr(self, "_owner_agent", None)
        if owner is not None:
            # connect_webrtc: the channel owns the ICE socket — close it
            # AFTER the SCTP SHUTDOWN / DTLS close_notify drain above, or
            # (on proactor loops) the farewell datagrams are dropped and
            # the server keeps a ghost client until the no-progress abort
            self._owner_agent = None
            owner.close()  # re-entry is safe: self.closed is already set

    def _drain_dtls_best_effort(self) -> None:
        try:
            for dg in self.dtls.outgoing():
                self._send_datagram(dg)
        except Exception:
            pass


class _Awaitable:
    """Awaiting this is a no-op; not awaiting it warns nobody."""

    def __await__(self):
        return iter(())


async def _http_post_sdp(host: str, port: int, path: str,
                         body: str, timeout: float = 10.0) -> str:
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        data = body.encode()
        writer.write(
            f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Content-Type: application/sdp\r\n"
            f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        await writer.drain()
        status = await asyncio.wait_for(reader.readline(), timeout)
        parts = status.split()
        if len(parts) < 2 or parts[1] != b"200":
            raise ConnectionError(
                f"webrtc signaling rejected: {status.decode(errors='replace').strip()}")
        headers: dict[str, str] = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode(errors="replace").partition(":")
            headers[k.strip().lower()] = v.strip()
        clen = int(headers.get("content-length", "0"))
        payload = await asyncio.wait_for(reader.readexactly(clen), timeout)
        return payload.decode()
    finally:
        writer.close()


async def connect_webrtc(host: str, port: int,
                         timeout: float = 15.0) -> DataChannelTransport:
    """Dial a server over WebRTC: POST an SDP offer to its /webrtc/offer
    signaling endpoint (the websocket listener), run ICE -> DTLS -> SCTP,
    and return the ready ACIP transport. This is the native client's
    WebRTC transport (src/client/webrtc.c role) — the same path a browser
    takes, so a native `--webrtc` client and a browser are
    indistinguishable to the server."""
    from asciichat_tpu_torch.net import sdp
    from asciichat_tpu_torch.net.webrtc import IceLiteAgent

    agent = IceLiteAgent(controlling=True, dtls=True)
    await agent.start()
    try:
        answer = await _http_post_sdp(host, port, "/webrtc/offer",
                                      sdp.offer_for_agent(agent), timeout)
        info = sdp.parse(answer)
        if not info.fingerprint:
            raise ConnectionError("server SDP answer carries no fingerprint")
        agent.set_remote(info.to_desc())
        ch = await agent.wait_connected(timeout)
        ch = await ch.wait_ready(timeout)
        ch._owner_agent = agent  # the channel owns the ICE socket's lifetime
        return ch
    except BaseException:
        agent.close()
        raise
