"""Transport abstraction: framed ACIP packet streams over asyncio TCP.

Mirrors the reference's transport vtable (acip_transport_t,
include/ascii-chat/network/acip/transport.h:95-105) with TCP implemented and
WebSocket/WebRTC as future transports. Where the reference spawns
receive/send/dispatch threads per client (src/server/client.c:551-598), this
runtime uses asyncio tasks + per-connection send queues (the packet-queue
analog of lib/network/packet/queue.c).
"""

from __future__ import annotations

import asyncio
import contextlib

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.utils.logsys import DEV, get_logger

_log = get_logger("packet")


def _trace(direction: str, ptype: int, size: int) -> None:
    """Packet tracing (debug-build packet tracing parity, README.md:253);
    DEV level so it is free unless --log-level DEV."""
    if _log.isEnabledFor(DEV):
        try:
            name = pkt.PacketType(ptype).name
        except ValueError:
            name = str(ptype)
        _log.log(DEV, "%s %s (%d bytes)", direction, name, size)


class _QueuedSender:
    """Shared bounded-queue sender machinery for framed transports.

    One implementation for the TCP Transport AND the WebSocket transport
    (net/websocket.py): the two used to be near-verbatim copies, and the
    copies drifted — the WS one lost the dead-sender check in send_nowait
    and the bounded close() await, re-growing the exact hang/buffer-bloat
    bugs fixed in the TCP twin. Subclasses provide `async _write_one(buf)`
    (write + flush one framed packet on the underlying stream)."""

    QUEUE_MAX = 256

    def _init_sender(self) -> None:
        self._send_queue: asyncio.Queue[bytes | None] = asyncio.Queue(
            maxsize=self.QUEUE_MAX)
        self._sender_task: asyncio.Task | None = None
        # Bytes currently sitting in the queue. The 256-packet bound alone
        # is no memory bound at all for video: 256 x ~885 KiB raw-RGB
        # IMAGE_FRAMEs is ~226 MB PER CLIENT, and a 9-client warmup was
        # measured holding 1.1 GiB of queued frames (the "2.8 GB soak
        # peak" was mostly this, not XLA). Callers shipping bulky
        # latest-wins payloads pass byte_cap to send_nowait and get
        # reference double-buffer semantics (video_frame.c: keep latest,
        # drop stale) instead of a deep stale backlog.
        self._queued_bytes = 0

    def start_sender(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._sender_task = self._loop.create_task(self._sender())

    async def _sender(self) -> None:
        try:
            while True:
                buf = await self._send_queue.get()
                if buf is None:
                    break
                # dequeue accounting BEFORE the (possibly long) write: the
                # budget bounds memory held in the queue, and the write
                # buffer below is the same bytes object, not a copy
                self._queued_bytes -= len(buf)
                await self._write_one(buf)
        except asyncio.CancelledError:
            pass
        except (ConnectionError, OSError, RuntimeError):
            # drain() can raise past ConnectionError (ENOBUFS OSError, the
            # 'transport is closing' RuntimeError); the task must exit
            # cleanly either way — an unretrieved exception is just noise
            pass

    async def send(self, ptype: int, payload: bytes = b"") -> None:
        """Queue a packet. A FULL queue raises ConnectionError: a stalled
        peer (TCP zero window) must disconnect like the reference's bounded
        per-client queues drop it — blocking here would freeze the caller's
        recv loop behind its own slowest client."""
        _trace("send", ptype, len(payload))
        buf = pkt.pack_packet(ptype, payload)
        if self._sender_task is None:
            await self._write_one(buf)
            return
        if self._sender_task.done():
            raise ConnectionError("sender task dead (peer gone)")
        try:
            self._send_queue.put_nowait(buf)
            self._queued_bytes += len(buf)
        except asyncio.QueueFull:
            raise ConnectionError(
                "send queue overflow (stalled peer)") from None

    def send_nowait(self, ptype: int, payload: bytes = b"", *,
                    byte_cap: int | None = None) -> bool:
        """Non-blocking enqueue; returns False when the queue is full (the
        frame is dropped — overload shedding, pipeline.c:72-80).

        THREAD-SAFE: the render/audio ticks call this from executor threads,
        but asyncio.Queue is loop-affine (put_nowait wakes the sender task's
        getter future, and a cross-thread Future.set_result can race the
        event loop into InvalidStateError / lost wakeups). Off-loop callers
        get their enqueue marshalled via call_soon_threadsafe; `full()` is a
        benign approximation for the drop decision there.

        The full()/dead-sender checks run BEFORE pack_packet: shedding is
        hot exactly when the queue is full, and paying a CRC32-C over a
        multi-MB frame just to drop it defeats the point. A dead sender
        (peer reset) reports False like send() raises — otherwise the tick
        keeps buffering frames into a queue nobody will ever drain."""
        task = self._sender_task
        if task is not None and task.done():
            return False
        loop = getattr(self, "_loop", None)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if self._send_queue.full():
            return False
        # byte budget (latest-wins shedding for bulky payloads): checked
        # before pack_packet for the same reason as full() — shedding is
        # hot exactly when the backlog is deep. Off-loop readers see a
        # GIL-atomic int; like full() it is a benign approximation there.
        if byte_cap is not None and self._queued_bytes + len(payload) > byte_cap:
            return False
        if loop is not None and running is not loop:
            try:
                loop.call_soon_threadsafe(self._put_drop, pkt.pack_packet(ptype, payload))
            except RuntimeError:
                return False  # loop already closed
            return True
        try:
            buf = pkt.pack_packet(ptype, payload)
            self._send_queue.put_nowait(buf)
            self._queued_bytes += len(buf)
            return True
        except asyncio.QueueFull:
            return False

    def _put_drop(self, buf: bytes) -> None:
        with contextlib.suppress(asyncio.QueueFull):
            self._send_queue.put_nowait(buf)
            self._queued_bytes += len(buf)

    async def _drain_sender(self) -> None:
        """Stop the sender with a BOUNDED best-effort flush."""
        if self._sender_task is None:
            return
        # NEVER a blocking put: if the sender died with a full queue
        # (stalled peer that then reset), put(None) would block forever
        # and leak the connection task + transport + socket
        try:
            self._send_queue.put_nowait(None)
        except asyncio.QueueFull:
            self._sender_task.cancel()
        # BOUNDED flush: the sender can be parked in drain() against a
        # peer that stopped reading (TCP zero window) with the queue NOT
        # full, so the sentinel alone never unblocks it and a bare await
        # would hang close() forever. wait_for cancels the task on
        # timeout, which interrupts drain().
        with contextlib.suppress(asyncio.CancelledError, TimeoutError,
                                 asyncio.TimeoutError):
            await asyncio.wait_for(self._sender_task, timeout=2.0)


class Transport(_QueuedSender):
    """One framed ACIP connection (either side)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._init_sender()
        self.closed = False

    @property
    def peername(self):
        return self.writer.get_extra_info("peername")

    async def _write_one(self, buf: bytes) -> None:
        self.writer.write(buf)
        await self.writer.drain()

    async def recv(self) -> tuple[int, bytes]:
        """Read one verified packet -> (type, payload).

        Raises ValueError on magic/CRC violations (callers disconnect the
        peer, mirroring disconnect_client_for_bad_data, protocol.c:755)."""
        hdr = await self.reader.readexactly(pkt.HEADER_SIZE)
        ptype, length, crc, _cid = pkt.unpack_header(hdr)
        payload = await self.reader.readexactly(length) if length else b""
        if not pkt.verify_payload(payload, crc):
            raise ValueError(f"payload CRC mismatch for packet type {ptype}")
        _trace("recv", ptype, length)
        return ptype, payload

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        await self._drain_sender()
        with contextlib.suppress(ConnectionError, OSError):
            self.writer.close()
            try:
                # close() flushes buffered data before closing — against the
                # same stalled peer that parked the sender, that flush never
                # finishes and wait_closed() is a second forever-hang. Bound
                # it and abort(): dropping undeliverable bytes IS the
                # disconnect semantics here.
                await asyncio.wait_for(self.writer.wait_closed(), timeout=2.0)
            except (TimeoutError, asyncio.TimeoutError):
                self.writer.transport.abort()


async def connect_tcp(host: str, port: int) -> Transport:
    reader, writer = await asyncio.open_connection(host, port)
    t = Transport(reader, writer)
    t.start_sender()
    return t


async def serve_tcp(handler, host: str, port: int) -> asyncio.AbstractServer:
    """Listen and invoke `await handler(transport)` per connection."""

    async def on_conn(reader, writer):
        t = Transport(reader, writer)
        t.start_sender()
        try:
            await handler(t)
        finally:
            await t.close()

    return await asyncio.start_server(on_conn, host, port)
