"""SCTP over DTLS (RFC 9260 subset + RFC 8831/8832 DataChannels) — sans-io.

Role parity: the reference's WebRTC DataChannels (lib/network/webrtc/webrtc.c
via libdatachannel, which embeds usrsctp) carry ACIP packets between browsers
and native peers. This module implements the interoperable subset an SCTP
peer needs on top of DTLS (RFC 8261: one path, no multihoming, DTLS provides
integrity/privacy — the CRC32c stays, computed exactly as net/packet.crc32c):

- 4-way handshake: INIT -> INIT_ACK (state cookie) -> COOKIE_ECHO -> COOKIE_ACK
- DATA with fragmentation (B/E flags), TSN-based reliability, per-stream
  ordered delivery (SSN), unordered (U flag) delivery
- SACK with cumulative ack + gap-ack blocks (generated and honored),
  delayed SACK (every 2nd in-order packet; immediate on gaps; tick() as
  the timer bound), fast retransmit with a fast-recovery exit point,
  cwnd slow start / congestion avoidance, RTT-adaptive RTO (RFC 6298
  form, Karn's rule), T3-rtx retransmission with exponential backoff,
  time-based (not retry-count) association failure detection
- HEARTBEAT response, ABORT, graceful SHUTDOWN sequence
- DCEP (RFC 8832): DATA_CHANNEL_OPEN / DATA_CHANNEL_ACK on WebRTC PPIDs

Deliberately omitted (not needed for reliable-ordered DataChannels, and
tolerated-absent by browser stacks): multihoming, FORWARD-TSN/partial
reliability, RE-CONFIG stream reset, path verification (the path IS the
DTLS connection).

Sans-io: `SctpAssociation` never touches a socket or event loop. Packets in
via `on_packet()`, out via the `send_cb`; timers via `tick(now)`. The asyncio
side lives in net/datachannel.py.

Unknown chunks/params follow the RFC 9260 §3.2/§3.2.1 upper-bits action
rules so future peers' extensions (RE-CONFIG, FORWARD-TSN advertisements)
degrade gracefully instead of aborting the association.

The port's copy of ``asciichat_tpu/net/sctp.py``, but for its receive
window (``A_RWND``), which holds the largest ACIP packet.
"""

from __future__ import annotations

import collections
import hashlib
import hmac
import os
import struct
import time

from asciichat_tpu_torch.net.packet import MAX_PACKET_SIZE, crc32c
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("sctp")

# chunk types (RFC 9260 §3.2)
CT_DATA = 0
CT_INIT = 1
CT_INIT_ACK = 2
CT_SACK = 3
CT_HEARTBEAT = 4
CT_HEARTBEAT_ACK = 5
CT_ABORT = 6
CT_SHUTDOWN = 7
CT_SHUTDOWN_ACK = 8
CT_ERROR = 9
CT_COOKIE_ECHO = 10
CT_COOKIE_ACK = 11
CT_SHUTDOWN_COMPLETE = 14

PARAM_STATE_COOKIE = 7

# DATA flags
F_UNORDERED = 0x04
F_BEGIN = 0x02
F_END = 0x01

# WebRTC PPIDs (RFC 8831 §8)
PPID_DCEP = 50
PPID_STRING = 51
PPID_BINARY = 53

# DCEP (RFC 8832)
DCEP_OPEN = 0x03
DCEP_ACK = 0x02
DC_TYPE_RELIABLE_ORDERED = 0x00

_COMMON = struct.Struct(">HHI")  # src port, dst port, vtag (+ checksum, LE)
_CHUNK = struct.Struct(">BBH")  # type, flags, length
_DATA_HDR = struct.Struct(">IHHI")  # tsn, stream id, ssn, ppid
_SACK_HDR = struct.Struct(">IIHH")  # cum tsn, a_rwnd, n_gaps, n_dups

# The receive window. A message is delivered only whole (no partial
# delivery), so the window must hold the largest ACIP packet with room for
# the next one's first chunks. The JAX package's copy advertises 1 MiB:
# there a message above it (an 800x600 IMAGE_FRAME is 1.44 MB) fills the
# window before it is whole and stalls for seconds, and one of 5 MiB never
# completes (tests/test_torch_datachannel.py holds both).
A_RWND = MAX_PACKET_SIZE + (1 << 20)
RTO_INIT = 0.5
RTO_MAX = 4.0
MAX_RETX = 10  # handshake flights (INIT / COOKIE_ECHO)
# DATA-path failure detection is TIME-based, not count-based: an
# association that made ANY forward progress in this window stays up. A
# per-chunk retransmit cap aborts spuriously on a merely-saturated link
# (observed: a 3-client soak on one core shed load exactly as designed,
# yet individual frames' chunks hit 10 retransmits while the association
# as a whole was healthy). 30 s of NO cumulative progress means the peer
# is gone (the reference's transports behave the same way: keepalive
# timeouts, not packet-retry counts — src/client/keepalive.c role).
NO_PROGRESS_ABORT_S = 30.0


def _u32(x: int) -> int:
    return x & 0xFFFFFFFF


def _tsn_lt(a: int, b: int) -> bool:
    """Serial-number arithmetic (RFC 1982): a < b on the 32-bit circle."""
    d = (b - a) & 0xFFFFFFFF
    return 0 < d < 0x80000000


def pack_packet(src: int, dst: int, vtag: int, chunks: bytes) -> bytes:
    """Common header + chunks; CRC32c computed over the whole packet with a
    zero checksum field and stored LITTLE-endian (RFC 9260 Appendix B: the
    reflected CRC's bytes go least-significant first — the one byte-order
    trap every SCTP implementation documents)."""
    head = _COMMON.pack(src, dst, vtag) + b"\0\0\0\0"
    crc = crc32c(head + chunks)
    return head[:8] + struct.pack("<I", crc) + chunks


def unpack_packet(data: bytes) -> tuple[int, int, int, list[tuple[int, int, bytes]]]:
    """-> (src, dst, vtag, [(chunk_type, flags, value_bytes)]). Raises
    ValueError on bad length/checksum."""
    if len(data) < 12:
        raise ValueError("short SCTP packet")
    src, dst, vtag = _COMMON.unpack_from(data, 0)
    (got_crc,) = struct.unpack_from("<I", data, 8)
    if crc32c(data[:8] + b"\0\0\0\0" + data[12:]) != got_crc:
        raise ValueError("SCTP checksum mismatch")
    chunks = []
    at = 12
    while at + 4 <= len(data):
        ctype, flags, length = _CHUNK.unpack_from(data, at)
        if length < 4 or at + length > len(data):
            raise ValueError("bad chunk length")
        chunks.append((ctype, flags, data[at + 4 : at + length]))
        at += (length + 3) & ~3  # chunks pad to 4
    return src, dst, vtag, chunks


def _chunk(ctype: int, flags: int, value: bytes) -> bytes:
    pad = (-len(value)) % 4
    return _CHUNK.pack(ctype, flags, 4 + len(value)) + value + b"\0" * pad


def _params(value: bytes):
    """Iterate (type, value) TLV params, tolerating unknown ones."""
    at = 0
    while at + 4 <= len(value):
        ptype, plen = struct.unpack_from(">HH", value, at)
        if plen < 4 or at + plen > len(value):
            return
        yield ptype, value[at + 4 : at + plen]
        at += (plen + 3) & ~3


class SctpAssociation:
    """One SCTP association over a datagram security layer (DTLS record =
    one SCTP packet). `send_cb(packet_bytes)` transmits; feed inbound
    packets to `on_packet()`; call `tick(now)` periodically (~50-100 ms)
    for retransmission timers.

    Callbacks (set before connect/first packet):
      on_message(stream_id, ppid, data)   complete user message delivered
      on_established()                    association up
      on_closed(reason)                   ABORT/SHUTDOWN/too many retx
    """

    def __init__(self, send_cb, client: bool, local_port: int = 5000,
                 remote_port: int = 5000, frag_size: int = 1100,
                 now_fn=time.monotonic):
        self._send = send_cb
        self.client = client
        self.local_port = local_port
        self.remote_port = remote_port
        self.frag = frag_size
        self._now = now_fn

        self.state = "closed"  # closed/cookie-wait/cookie-echoed/established/
        #                        shutdown-sent/shutdown-received/done
        self.my_vtag = struct.unpack(">I", os.urandom(4))[0] or 1
        self.peer_vtag = 0
        self.my_tsn = struct.unpack(">I", os.urandom(4))[0]  # next to assign
        self.peer_rwnd = A_RWND

        # sender
        self._outstanding: dict[int, list] = {}  # tsn -> [bytes, t_sent, retx, miss]
        self._out_order: list[int] = []  # tsns in send order
        # DATA chunks not yet transmitted; deque: _flush popped a LIST's
        # head per chunk — O(n^2) per flush with ~950 tuples buffered
        self._send_queue: collections.deque = collections.deque()
        self._rto = RTO_INIT
        self._t3_start: float | None = None
        self._ssn_out: dict[int, int] = {}
        # congestion control (RFC 9260 §7, simplified single-path form):
        # slow start from 4 MTU, +MTU per cum-advancing SACK in slow start,
        # +MTU²/cwnd in congestion avoidance; halve on fast retransmit,
        # collapse to the initial window on T3 expiry. Without this, a
        # burst blasts straight through socket buffers (observed: 256 KB
        # into a loopback rcvbuf drops half the flight).
        self._mtu_budget = self.frag + 16 + 12  # one bundle's packet bytes
        self.cwnd = 4 * self._mtu_budget
        self.ssthresh = 256 * 1024
        self._last_progress = self._now()
        # RTT estimator (RFC 6298 form, Karn's rule: never sample a
        # retransmitted chunk) — without it, a fixed 0.5 s RTO fires
        # spuriously on every burst start once path RTT exceeds it
        self._srtt: float | None = None
        self._rttvar = 0.0
        # fast-recovery exit point: cwnd halves at most once per loss
        # window (RFC 9260 §7.2.4), not once per triggering SACK
        self._fr_exit: int | None = None
        # highest cumulative TSN the peer has acked (the Cumulative TSN Ack
        # Point, §6.2.1): SACKs older than this are reordered-UDP stragglers
        # and must be dropped whole — processing one would overwrite
        # peer_rwnd with stale data and re-run miss counters on chunks that
        # are not missing (spurious fast retransmit + cwnd halving)
        self._cum_acked: int | None = None

        # receiver
        self._sack_owed = 0  # packets-with-DATA since the last SACK
        self._rcv_buffered = 0  # bytes held in frag_hold + ordered_hold
        self.cum_tsn = 0  # last consecutively received (set from INIT)
        self._received: dict[int, tuple] = {}  # tsn -> (flags, sid, ssn, ppid, data)
        self._frag_hold: dict[int, tuple] = {}  # undelivered chunk store
        self._next_ssn_in: dict[int, int] = {}
        self._ordered_hold: dict[int, dict[int, tuple]] = {}  # sid -> ssn -> (ppid,msg)

        # handshake retransmission
        self._hs_chunk: bytes | None = None
        self._hs_vtag = 0
        self._hs_start: float | None = None
        self._hs_retx = 0

        self._cookie_secret = os.urandom(32)
        self.established_at: float | None = None
        self.on_message = lambda sid, ppid, data: None
        self.on_established = lambda: None
        self.on_closed = lambda reason: None

        # DCEP
        self._dcep_acked: set[int] = set()
        self.on_channel_open = lambda sid, label: None
        self.on_channel_acked = lambda sid: None

    # -- handshake ------------------------------------------------------------
    def connect(self) -> None:
        """Client side: kick off INIT. (RFC 9260 §5.1; INIT rides vtag 0.)"""
        init = _chunk(CT_INIT, 0, struct.pack(
            ">IIHHI", self.my_vtag, A_RWND, 65535, 65535, self.my_tsn))
        self.state = "cookie-wait"
        self._hs_chunk, self._hs_vtag = init, 0
        self._hs_start, self._hs_retx = self._now(), 0
        self._xmit(init, vtag=0)

    def _xmit(self, chunks: bytes, vtag: int | None = None) -> None:
        self._send(pack_packet(self.local_port, self.remote_port,
                               self.peer_vtag if vtag is None else vtag,
                               chunks))

    def _make_cookie(self, peer_vtag: int, peer_tsn: int) -> bytes:
        body = struct.pack(">IIIId", self.my_vtag, peer_vtag, self.my_tsn,
                           peer_tsn, self._now())
        mac = hmac.new(self._cookie_secret, body, hashlib.sha256).digest()
        return body + mac

    def _check_cookie(self, cookie: bytes) -> tuple[int, int] | None:
        if len(cookie) != 24 + 32:
            return None
        body, mac = cookie[:24], cookie[24:]
        if not hmac.compare_digest(
            hmac.new(self._cookie_secret, body, hashlib.sha256).digest(), mac
        ):
            return None
        my_vtag, peer_vtag, my_tsn, peer_tsn, _ts = struct.unpack(">IIIId", body)
        if my_vtag != self.my_vtag:
            return None
        return peer_vtag, peer_tsn

    # -- inbound --------------------------------------------------------------
    def on_packet(self, data: bytes) -> None:
        try:
            _src, _dst, vtag, chunks = unpack_packet(data)
        except ValueError as e:
            log.debug("dropping bad SCTP packet: %s", e)
            return
        if self.state == "done":
            return
        has_init = any(ct == CT_INIT for ct, _f, _v in chunks)
        if has_init and (len(chunks) > 1 or vtag != 0):
            # INIT MUST be the sole chunk in its packet and ride vtag 0
            # (RFC 9260 §5.1): a bundled INIT used to disable the vtag
            # check for every OTHER chunk in the packet, letting a forged
            # INIT+ABORT with a garbage vtag kill an established
            # association
            log.debug("dropping packet bundling INIT with other chunks")
            return
        if not has_init and vtag != self.my_vtag:
            # INIT_ACK arrives on the client before peer_vtag is known but
            # is keyed to OUR tag, so the same check applies (RFC 9260 §8.5)
            log.debug("dropping SCTP packet with bad vtag")
            return
        saw_data = False
        for ctype, flags, value in chunks:
            if self.state == "done":
                # nothing after an ABORT/SHUTDOWN_COMPLETE in the same
                # packet may be processed (§8.5.1) — bundled DATA used to
                # fire on_message AFTER on_closed
                return
            if ctype == CT_DATA:
                saw_data |= self._on_data(flags, value)
            elif ctype == CT_SACK:
                self._on_sack(value)
            elif ctype == CT_INIT:
                self._on_init(value)
            elif ctype == CT_INIT_ACK:
                self._on_init_ack(value)
            elif ctype == CT_COOKIE_ECHO:
                self._on_cookie_echo(value)
            elif ctype == CT_COOKIE_ACK:
                self._on_cookie_ack()
            elif ctype == CT_HEARTBEAT:
                # echo the heartbeat info params back (RFC 9260 §8.3)
                self._xmit(_chunk(CT_HEARTBEAT_ACK, 0, value))
            elif ctype == CT_ABORT:
                self._close("peer abort")
            elif ctype == CT_SHUTDOWN:
                # §9.2: the SHUTDOWN receiver must DRAIN its own
                # outstanding/queued DATA before SHUTDOWN_ACK — acking
                # immediately destroyed any message still in flight the
                # other way (verified: 0 of 5000 bytes delivered when a
                # graceful close raced a cwnd-limited send). The chunk's
                # Cumulative TSN Ack frees our in-flight data like a SACK.
                if len(value) >= 4:
                    (sh_cum,) = struct.unpack_from(">I", value)
                    self._on_sack(_SACK_HDR.pack(sh_cum, self.peer_rwnd, 0, 0))
                if self.state in ("established", "shutdown-pending",
                                  "shutdown-sent"):
                    self.state = "shutdown-received"
                self._maybe_shutdown_ack()
            elif ctype == CT_SHUTDOWN_ACK:
                # best-effort COMPLETE: if it is lost, the peer's
                # retransmitted SHUTDOWN_ACK eventually exhausts ITS retx
                # budget and closes — bounded, unlike the pre-fix wedge
                self._xmit(_chunk(CT_SHUTDOWN_COMPLETE, 0, b""))
                self._close("shutdown complete")
            elif ctype == CT_SHUTDOWN_COMPLETE:
                self._close("shutdown complete")
            elif ctype in (CT_HEARTBEAT_ACK, CT_ERROR):
                pass
            elif ctype & 0x80:
                continue  # unknown, skip (upper bits 10/11)
            else:
                break  # unknown, stop processing this packet (00/01)
        if saw_data:
            # delayed SACK (RFC 9260 §6.2): ack every SECOND in-order
            # packet (tick() covers the 200 ms timer with its 50-100 ms
            # cadence) — halves reverse-path packets on bulk transfer.
            # Gaps always SACK immediately: fast retransmit feeds on them.
            self._sack_owed += 1
            if self._received or self._sack_owed >= 2:
                self._send_sack()
            self._flush()  # rwnd may allow more after delivery

    def _on_init(self, value: bytes) -> None:
        if len(value) < 16:
            return
        peer_vtag, rwnd, _os, _is, peer_tsn = struct.unpack_from(">IIHHI", value)
        self.peer_rwnd = rwnd
        cookie = self._make_cookie(peer_vtag, peer_tsn)
        ack = _chunk(CT_INIT_ACK, 0, struct.pack(
            ">IIHHI", self.my_vtag, A_RWND, 65535, 65535, self.my_tsn)
            + struct.pack(">HH", PARAM_STATE_COOKIE, 4 + len(cookie)) + cookie
            + b"\0" * ((-len(cookie)) % 4))
        # INIT_ACK is addressed with the peer's initiate tag (RFC 9260 §5.1)
        self._send(pack_packet(self.local_port, self.remote_port, peer_vtag, ack))

    def _on_init_ack(self, value: bytes) -> None:
        if self.state != "cookie-wait" or len(value) < 16:
            return
        peer_vtag, rwnd, _os, _is, peer_tsn = struct.unpack_from(">IIHHI", value)
        cookie = None
        for ptype, pval in _params(value[16:]):
            if ptype == PARAM_STATE_COOKIE:
                cookie = pval
        if cookie is None:
            return
        self.peer_vtag = peer_vtag
        self.peer_rwnd = rwnd
        self.cum_tsn = _u32(peer_tsn - 1)
        self.state = "cookie-echoed"
        echo = _chunk(CT_COOKIE_ECHO, 0, cookie)
        self._hs_chunk, self._hs_vtag = echo, self.peer_vtag
        self._hs_start, self._hs_retx = self._now(), 0
        self._xmit(echo)

    def _on_cookie_echo(self, cookie: bytes) -> None:
        got = self._check_cookie(cookie)
        if got is None:
            log.warning("bad SCTP state cookie; dropping")
            return
        peer_vtag, peer_tsn = got
        if self.state != "established":
            # a RETRANSMITTED cookie (our COOKIE_ACK was lost) must not
            # reset receiver state the first echo already initialized
            self.peer_vtag = peer_vtag
            self.cum_tsn = _u32(peer_tsn - 1)
        self._xmit(_chunk(CT_COOKIE_ACK, 0, b""))
        if self.state != "established":
            self._establish()

    def _on_cookie_ack(self) -> None:
        if self.state == "cookie-echoed":
            self._establish()

    def _establish(self) -> None:
        self.state = "established"
        self.established_at = self._now()
        self._last_progress = self.established_at
        self._hs_chunk = None
        log.info("SCTP association established (%s)",
                 "client" if self.client else "server")
        self.on_established()
        self._flush()

    def _transmit_chunk(self, flags, sid, ssn, ppid, piece) -> bytes:
        """Assign a TSN, build and track one DATA chunk (shared by the
        bundling loop and the zero-window probe — two verbatim copies had
        to be kept in sync before)."""
        tsn = self.my_tsn
        self.my_tsn = _u32(self.my_tsn + 1)
        ch = _chunk(CT_DATA, flags, _DATA_HDR.pack(tsn, sid, ssn, ppid) + piece)
        self._outstanding[tsn] = [ch, self._now(), 0, 0]
        self._out_order.append(tsn)
        return ch

    # -- DATA receive ---------------------------------------------------------
    def _on_data(self, flags: int, value: bytes) -> bool:
        # zero-length user data is a legal chunk (send(b"") emits one);
        # only a TRUNCATED header is malformed
        if len(value) < _DATA_HDR.size:
            return False
        tsn, sid, ssn, ppid = _DATA_HDR.unpack_from(value)
        data = value[_DATA_HDR.size :]
        if not _tsn_lt(self.cum_tsn, tsn) or tsn in self._received:
            return True  # duplicate: still triggers a SACK
        if len(self._received) > 4096 and tsn != _u32(self.cum_tsn + 1):
            # reassembly-buffer bound: drop, peer retransmits. cum+1 is
            # ALWAYS accepted — it is the chunk that advances the
            # cumulative point and drains this buffer; dropping it here
            # deadlocks the association (observed in the 3-client soak:
            # gap-acks free the sender's flight while cum stalls, the
            # bound fills, and the missing chunk's retransmissions bounce
            # off it forever).
            return True
        self._received[tsn] = True
        self._frag_hold[tsn] = (flags, sid, ssn, ppid, data)
        self._rcv_buffered += len(data)
        # advance the cumulative ack point (tsn <= cum needs no dup entry:
        # the _tsn_lt guard above already rejects it)
        while _u32(self.cum_tsn + 1) in self._received:
            self.cum_tsn = _u32(self.cum_tsn + 1)
            del self._received[self.cum_tsn]
        self._try_reassemble(tsn)
        return True

    def _try_reassemble(self, tsn: int) -> None:
        """A message is a consecutive TSN run B...E with the same stream.
        Walk back to the B fragment and forward to the E fragment; deliver
        when complete (fragments of one message have consecutive TSNs,
        RFC 9260 §6.9)."""
        start = tsn
        while True:
            ent = self._frag_hold.get(start)
            if ent is None:
                return
            if ent[0] & F_BEGIN:
                break
            start = _u32(start - 1)
        end = tsn
        while True:
            ent = self._frag_hold.get(end)
            if ent is None:
                return
            if ent[0] & F_END:
                break
            end = _u32(end + 1)
        parts = []
        t = start
        while True:
            parts.append(self._frag_hold[t])
            if t == end:
                break
            t = _u32(t + 1)
        flags, sid, ssn, ppid, _ = parts[0]
        msg = b"".join(p[4] for p in parts)
        t = start
        while True:
            del self._frag_hold[t]
            if t == end:
                break
            t = _u32(t + 1)
        if flags & F_UNORDERED:
            self._deliver(sid, ppid, msg)
        else:
            self._ordered_hold.setdefault(sid, {})[ssn] = (ppid, msg)
            nxt = self._next_ssn_in.setdefault(sid, 0)
            hold = self._ordered_hold[sid]
            while nxt in hold:
                ppid2, msg2 = hold.pop(nxt)
                self._deliver(sid, ppid2, msg2)
                nxt = (nxt + 1) & 0xFFFF
            self._next_ssn_in[sid] = nxt

    def _deliver(self, sid: int, ppid: int, msg: bytes) -> None:
        # every delivered byte was counted into _rcv_buffered on arrival
        self._rcv_buffered = max(0, self._rcv_buffered - len(msg))
        if ppid == PPID_DCEP:
            self._on_dcep(sid, msg)
        else:
            self.on_message(sid, ppid, msg)

    def _send_sack(self) -> None:
        self._sack_owed = 0
        gaps = []
        # gap-ack blocks: offsets relative to cum_tsn (RFC 9260 §3.3.4);
        # offsets beyond u16 range can't be represented and are simply not
        # reported (the peer retransmits them eventually)
        offs = sorted(o for o in (_u32(t - self.cum_tsn)
                                  for t in self._received) if o <= 0xFFFF)
        if offs:
            start = prev = offs[0]
            for o in offs[1:]:
                if o == prev + 1:
                    prev = o
                    continue
                gaps.append((start, prev))
                start = prev = o
            gaps.append((start, prev))
            gaps = gaps[:100]
        # honest window: what the reassembly buffer can still absorb — this
        # is what actually throttles a sender whose cum is stalled (its
        # gap-acked chunks left its flight accounting, so cwnd alone would
        # let it run away from the receive buffer)
        a_rwnd = max(0, A_RWND - self._rcv_buffered)
        body = _SACK_HDR.pack(self.cum_tsn, a_rwnd, len(gaps), 0)
        body += b"".join(struct.pack(">HH", s, e) for s, e in gaps)
        self._xmit(_chunk(CT_SACK, 0, body))

    # -- DATA send ------------------------------------------------------------
    def send(self, sid: int, ppid: int, data: bytes,
             unordered: bool = False) -> None:
        """Queue one user message (fragmented as needed) and try to flush."""
        if self.state in ("shutdown-pending", "shutdown-sent",
                          "shutdown-received", "done"):
            # §9.2: no new user data once a graceful shutdown is underway —
            # queueing here would black-hole it (_flush never transmits in
            # shutdown-sent/received, and shutdown-pending only DRAINS what
            # was queued before the close)
            raise ConnectionError(
                f"SCTP association closing ({self.state})")
        ssn = 0
        if not unordered:
            ssn = self._ssn_out.get(sid, 0)
            self._ssn_out[sid] = (ssn + 1) & 0xFFFF
        base_flags = F_UNORDERED if unordered else 0
        views = [data[i : i + self.frag] for i in range(0, len(data), self.frag)] or [b""]
        for i, piece in enumerate(views):
            flags = base_flags
            if i == 0:
                flags |= F_BEGIN
            if i == len(views) - 1:
                flags |= F_END
            # TSN is assigned at TRANSMIT time (_flush), not here: data may
            # be queued before connect(), and the INIT advertises my_tsn as
            # the initial TSN — chunks numbered below it would arrive
            # looking like duplicates and never be delivered
            self._send_queue.append((flags, sid, ssn, ppid, piece))
        self._flush()

    def _flush(self) -> None:
        """Transmit queued DATA chunks subject to the flight-size cap
        (min of peer rwnd and a fixed congestion cap), bundling chunks
        per packet up to the fragment budget. Also runs in
        shutdown-pending: a graceful close must DRAIN the queue, not
        strand it (§9.2 — SHUTDOWN goes out only once everything is
        delivered)."""
        if self.state not in ("established", "shutdown-pending",
                              "shutdown-received"):
            return
        cap = min(self.peer_rwnd, self.cwnd, 256 * 1024)
        inflight = sum(len(e[0]) for e in self._outstanding.values())
        bundle: list[bytes] = []
        bundled = 0
        # bundle budget: one max-size chunk (16 B headers + frag payload).
        # Packet = 12 B common header + budget; the DTLS record adds ~37 B,
        # so budget must keep 12 + budget + 37 <= the endpoint's 1200 MTU —
        # frag+16 = 1116 -> 1165-byte record. (frag+64 overflowed the MTU
        # by ~13 bytes when two chunks bundled.)
        budget = self.frag + 16
        while self._send_queue and inflight < cap:
            flags, sid, ssn, ppid, piece = self._send_queue[0]
            size = 16 + len(piece)  # chunk hdr 4 + DATA hdr 12 + payload
            if bundled and bundled + size > budget:
                self._xmit(b"".join(bundle))
                bundle, bundled = [], 0
                continue
            self._send_queue.popleft()
            ch = self._transmit_chunk(flags, sid, ssn, ppid, piece)
            bundle.append(ch)
            bundled += len(ch)
            inflight += len(ch)
        if bundle:
            self._xmit(b"".join(bundle))
        elif not self._outstanding and self._send_queue:
            # zero-window probe (RFC 9260 §6.1 A): with nothing in flight
            # and a closed window, one chunk goes anyway — a 0-rwnd
            # receiver whose buffer later drains has no other trigger to
            # reopen the flow
            flags, sid, ssn, ppid, piece = self._send_queue.popleft()
            self._xmit(self._transmit_chunk(flags, sid, ssn, ppid, piece))
        if self._outstanding and self._t3_start is None:
            # arming T3 from idle starts a NEW progress window: an
            # association that was quiet for >30 s must not be aborted on
            # its first post-idle loss without a single retransmission
            self._t3_start = self._now()
            self._last_progress = max(self._last_progress, self._t3_start)

    def _on_sack(self, value: bytes) -> None:
        if len(value) < _SACK_HDR.size:
            return
        cum, rwnd, n_gaps, _n_dups = _SACK_HDR.unpack_from(value)
        if self._cum_acked is not None and _tsn_lt(cum, self._cum_acked):
            return  # §6.2.1: older than the current ack point — drop whole
        cum_advanced = self._cum_acked is None or _tsn_lt(self._cum_acked, cum)
        self._cum_acked = cum
        self.peer_rwnd = rwnd
        now = self._now()
        earliest = self._out_order[0] if self._out_order else None
        acked_bytes = 0
        rtt_sample = None
        acked = [t for t in self._out_order if not _tsn_lt(cum, t)]
        for t in acked:
            ent = self._outstanding.pop(t, None)
            if ent is not None:
                acked_bytes += len(ent[0])
                if ent[2] == 0 and rtt_sample is None:  # Karn's rule
                    rtt_sample = now - ent[1]
        gap_acked = set()
        highest = cum
        for i in range(n_gaps):
            off = _SACK_HDR.size + 4 * i
            if off + 4 > len(value):
                break
            s, e = struct.unpack_from(">HH", value, off)
            for d in range(s, e + 1):
                gap_acked.add(_u32(cum + d))
            if _tsn_lt(highest, _u32(cum + e)):
                highest = _u32(cum + e)
        # gap-acked chunks leave the retransmit set (we never renege — the
        # receiver sits behind reliable DTLS, reneging can't happen)
        for t in gap_acked:
            ent = self._outstanding.pop(t, None)
            if ent is not None:
                acked_bytes += len(ent[0])
        self._out_order = [t for t in self._out_order if t in self._outstanding]
        if rtt_sample is not None:
            if self._srtt is None:
                self._srtt, self._rttvar = rtt_sample, rtt_sample / 2
            else:
                self._rttvar += 0.25 * (abs(self._srtt - rtt_sample)
                                        - self._rttvar)
                self._srtt += 0.125 * (rtt_sample - self._srtt)
        # fast-recovery exit: the loss window ends when cum passes the
        # highest TSN that was outstanding when it began
        if self._fr_exit is not None and not _tsn_lt(cum, self._fr_exit):
            self._fr_exit = None
        # congestion window growth (RFC 9260 §7.2.1/7.2.2): ONLY when the
        # cumulative point advances and not during fast recovery — pure
        # gap-ack SACKs during a loss episode used to inflate cwnd by an
        # MTU each, overdriving the already-lossy path
        if acked_bytes and cum_advanced and self._fr_exit is None:
            if self.cwnd <= self.ssthresh:
                self.cwnd += min(acked_bytes, self._mtu_budget)
            else:
                self.cwnd += max(1, self._mtu_budget * self._mtu_budget
                                 // self.cwnd)
        # fast retransmit (§7.2.4): chunks below the highest gap-acked TSN
        # that the SACK did not cover get a miss indication; at 3 they
        # retransmit immediately (bounded to one packet bundle per SACK)
        # instead of waiting out a backed-off T3 — the difference between
        # milliseconds and seconds of head-of-line stall per lost packet.
        if gap_acked:
            retx_bundle: list[bytes] = []
            retx_bytes = 0
            for t in self._out_order:
                if not _tsn_lt(t, highest):
                    break
                ent = self._outstanding[t]
                ent[3] += 1
                # >= 3, not == 3: a chunk that missed its retx slot because
                # the per-SACK budget was full must stay eligible (== would
                # strand every lost chunk but the first in a burst)
                if ent[3] >= 3 and retx_bytes + len(ent[0]) <= self._mtu_budget:
                    retx_bundle.append(ent[0])
                    retx_bytes += len(ent[0])
                    ent[1] = now
                    ent[2] += 1  # Karn's rule: a retransmitted chunk must
                    #              never contribute an RTT sample (its ack
                    #              could be for the ORIGINAL transmission,
                    #              measuring near-zero and collapsing RTO)
                    ent[3] = 0
            if retx_bundle:
                if self._fr_exit is None:  # halve once per loss window
                    self.ssthresh = max(self.cwnd // 2, 4 * self._mtu_budget)
                    self.cwnd = self.ssthresh
                    self._fr_exit = _u32(self.my_tsn - 1)
                self._xmit(b"".join(retx_bundle))
        if acked_bytes:
            self._last_progress = now
        if not self._outstanding:
            self._t3_start = None
            self._rto = self._computed_rto()
        elif earliest is not None and earliest not in self._outstanding:
            # forward progress: shed the backoff down to the RTT estimate
            self._rto = self._computed_rto()
            # RESTART T3 only when the earliest outstanding TSN was acked
            # (RFC 9260 §6.3.2 R3). A SACK whose cumulative point makes no
            # progress must NOT refresh the timer — that's the ack-refresh
            # starvation bug class (a continuously-SACKing receiver would
            # otherwise postpone retransmission of a lost chunk forever;
            # same failure the secretbox ARQ fixed for ack-only segments).
            self._t3_start = now
        self._flush()
        if (self.state == "shutdown-pending" and not self._outstanding
                and not self._send_queue):
            self._begin_shutdown()
        self._maybe_shutdown_ack()

    def _computed_rto(self) -> float:
        if self._srtt is None:
            return RTO_INIT
        return min(max(self._srtt + 4 * self._rttvar, 0.2), RTO_MAX)

    # -- timers ---------------------------------------------------------------
    def tick(self, now: float | None = None) -> None:
        """Drive retransmission timers; call every ~50-100 ms."""
        now = self._now() if now is None else now
        if self._sack_owed:  # delayed-SACK timer (§6.2's 200 ms bound)
            self._send_sack()
        if self._hs_chunk is not None and self._hs_start is not None:
            if now - self._hs_start >= min(RTO_INIT * (2 ** self._hs_retx), RTO_MAX):
                self._hs_retx += 1
                if self._hs_retx > MAX_RETX:
                    s = "handshake" if self.state in ("cookie-wait", "cookie-echoed") else "shutdown"
                    self._close(f"{s} retransmission timeout")
                    return
                self._hs_start = now
                self._xmit(self._hs_chunk, vtag=self._hs_vtag)
        if self._t3_start is not None and now - self._t3_start >= self._rto:
            # T3-rtx (§6.3.3): retransmit up to one packet bundle of the
            # earliest outstanding chunks, collapse the congestion window
            # to the initial size, back the timer off
            if now - self._last_progress > NO_PROGRESS_ABORT_S:
                self._abort(f"no forward progress in "
                            f"{NO_PROGRESS_ABORT_S:.0f}s")
                return
            bundle: list[bytes] = []
            bundled = 0
            for tsn in self._out_order:
                ent = self._outstanding.get(tsn)
                if ent is None:
                    continue
                if bundled + len(ent[0]) > self._mtu_budget and bundle:
                    break
                ent[2] += 1
                ent[1] = now
                ent[3] = 0
                bundle.append(ent[0])
                bundled += len(ent[0])
            if bundle:
                self.ssthresh = max(self.cwnd // 2, 4 * self._mtu_budget)
                self.cwnd = 4 * self._mtu_budget
                self._xmit(b"".join(bundle))
            self._rto = min(self._rto * 2, RTO_MAX)
            self._t3_start = now

    # -- shutdown -------------------------------------------------------------
    def shutdown(self) -> None:
        """Graceful: drain outstanding DATA, then SHUTDOWN (RFC 9260 §9.2)."""
        if self.state != "established":
            self._close("local close")
            return
        if self._outstanding or self._send_queue:
            self.state = "shutdown-pending"
        else:
            self._begin_shutdown()

    def _begin_shutdown(self) -> None:
        self.state = "shutdown-sent"
        sh = _chunk(CT_SHUTDOWN, 0, struct.pack(">I", self.cum_tsn))
        # T2-shutdown retransmission rides the handshake-retx machinery: a
        # single lost SHUTDOWN used to wedge BOTH endpoints permanently
        # (verified: 40 s of ticks, zero retransmits, peer a ghost forever)
        self._hs_chunk, self._hs_vtag = sh, None
        self._hs_start, self._hs_retx = self._now(), 0
        self._xmit(sh)

    def _maybe_shutdown_ack(self) -> None:
        if (self.state == "shutdown-received" and not self._outstanding
                and not self._send_queue):
            ack = _chunk(CT_SHUTDOWN_ACK, 0, b"")
            self._hs_chunk, self._hs_vtag = ack, None  # T2 retx for the ack
            self._hs_start, self._hs_retx = self._now(), 0
            self._xmit(ack)

    def _abort(self, reason: str) -> None:
        try:
            self._xmit(_chunk(CT_ABORT, 0, b""))
        except Exception:
            pass
        self._close(reason)

    def _close(self, reason: str) -> None:
        if self.state != "done":
            self.state = "done"
            self._hs_chunk = None
            self._t3_start = None
            log.info("SCTP association closed: %s", reason)
            self.on_closed(reason)

    # -- DCEP (RFC 8832) ------------------------------------------------------
    def open_channel(self, sid: int | None = None,
                     label: str = "acip") -> int:
        """Send DATA_CHANNEL_OPEN. Stream id parity follows the DTLS role
        (RFC 8832 §6: client uses even ids); returns the stream id."""
        if sid is None:
            sid = 0 if self.client else 1
        lab = label.encode()
        msg = struct.pack(">BBHIHH", DCEP_OPEN, DC_TYPE_RELIABLE_ORDERED,
                          0, 0, len(lab), 0) + lab
        self.send(sid, PPID_DCEP, msg)
        return sid

    def channel_acked(self, sid: int) -> bool:
        return sid in self._dcep_acked

    def _on_dcep(self, sid: int, msg: bytes) -> None:
        if not msg:
            return
        if msg[0] == DCEP_OPEN and len(msg) >= 12:
            label_len, _proto_len = struct.unpack_from(">HH", msg, 8)
            label = msg[12 : 12 + label_len].decode(errors="replace")
            try:
                self.send(sid, PPID_DCEP, bytes([DCEP_ACK]))
            except ConnectionError:
                # a DCEP_OPEN landing during shutdown: no ack channel left;
                # raising out of on_packet aborted the whole datagram batch
                return
            self.on_channel_open(sid, label)
        elif msg[0] == DCEP_ACK:
            self._dcep_acked.add(sid)
            self.on_channel_acked(sid)
