"""WebSocket transport: ACIP packets over RFC 6455 binary frames.

The port's copy of ``asciichat_tpu/net/websocket.py``, over the port's
``net/packet`` and ``net/transport``.

Parity with lib/network/websocket/{server,transport}.c (libwebsockets-based
browser access): each ACIP packet (22-byte header + payload) travels as one
binary WebSocket message. This is a dependency-free RFC 6455 implementation
(handshake, masking, fragmentation, ping/pong, close) on asyncio streams,
exposing the same Transport interface as net/transport.py so the server can
accept TCP and WebSocket clients on different ports interchangeably.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import hashlib
import os
import struct

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net.transport import _QueuedSender

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10

# One ACIP packet per message; anything beyond header+max payload is hostile.
# Mirrors the TCP transport's pre-read MAX_PACKET_SIZE gate so a peer on the
# public ws port cannot claim a multi-GB frame and exhaust memory.
MAX_MESSAGE_SIZE = pkt.MAX_PACKET_SIZE + pkt.HEADER_SIZE


def _xor_mask(payload: bytes, mask: bytes) -> bytes:
    """Vectorized frame (un)masking: the per-byte Python loop costs ~100 ms
    for one 1.4 MB camera upload ON THE EVENT LOOP; numpy does it in ~1 ms."""
    if not payload:
        return payload
    import numpy as np

    data = np.frombuffer(payload, np.uint8)
    m = np.frombuffer((mask * (len(data) // 4 + 1))[: len(data)], np.uint8)
    return (data ^ m).tobytes()


def _accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


async def _read_http_headers(reader: asyncio.StreamReader) -> tuple[str, dict[str, str]]:
    """Tolerant header read for a public port: binary garbage (TLS probes,
    scanners) decodes with replacement instead of raising out of on_conn,
    and the header count is bounded (a stream of unique headers must not
    grow the dict without limit)."""
    request_line = (await reader.readline()).decode(errors="replace").strip()
    headers: dict[str, str] = {}
    for _ in range(256):
        line = (await reader.readline()).decode(errors="replace").strip()
        if not line:
            break
        k, _, v = line.partition(":")
        k = k.strip().lower()
        # RFC 7230 §3.2.2: repeated header fields combine as a comma list —
        # overwriting dropped all but the last Sec-WebSocket-Extensions line
        headers[k] = f"{headers[k]}, {v.strip()}" if k in headers else v.strip()
    else:
        raise ValueError("too many http headers")
    return request_line, headers


class WebSocketConnection:
    """Framed RFC 6455 connection (post-handshake), with optional
    permessage-deflate (RFC 7692) when both ends negotiated it — the
    reference's libwebsockets transport negotiates the same extension
    (lib/network/websocket/transport.c). Compression uses one shared sliding
    context per direction (context takeover), RSV1 marks compressed
    messages, and only data messages >= 64 B are compressed."""

    DEFLATE_MIN_SIZE = 64

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 is_client: bool, deflate: bool = False,
                 tx_wbits: int = 15, tx_no_ctx: bool = False):
        self.reader = reader
        self.writer = writer
        self.is_client = is_client  # clients mask, servers don't
        self.closed = False
        self.deflate = deflate
        if deflate:
            import zlib

            # negotiated compressor parameters (RFC 7692 §7.1): the peer's
            # *_max_window_bits caps OUR compression window (its inflater
            # only keeps that much history) and *_no_context_takeover means
            # it discards history per message, so we must reset the
            # compressor per message. A 15-bit decompressor inflates any
            # smaller-window / context-reset stream, so rx needs no knobs.
            self._tx_wbits = tx_wbits
            self._tx_no_ctx = tx_no_ctx
            self._tx = zlib.compressobj(wbits=-tx_wbits)
            self._rx = zlib.decompressobj(wbits=-15)
            self._z_sync = zlib.Z_SYNC_FLUSH

    async def send_message(self, data: bytes, opcode: int = OP_BINARY) -> None:
        rsv1 = 0
        if (self.deflate and opcode in (OP_TEXT, OP_BINARY)
                and len(data) >= self.DEFLATE_MIN_SIZE):
            if self._tx_no_ctx:
                import zlib

                self._tx = zlib.compressobj(wbits=-self._tx_wbits)
            out = self._tx.compress(data) + self._tx.flush(self._z_sync)
            data = out[:-4] if out.endswith(b"\x00\x00\xff\xff") else out
            rsv1 = 0x40
        fin_op = 0x80 | rsv1 | opcode
        n = len(data)
        mask_bit = 0x80 if self.is_client else 0
        if n < 126:
            header = struct.pack(">BB", fin_op, mask_bit | n)
        elif n < 65536:
            header = struct.pack(">BBH", fin_op, mask_bit | 126, n)
        else:
            header = struct.pack(">BBQ", fin_op, mask_bit | 127, n)
        if self.is_client:
            mask = os.urandom(4)
            self.writer.write(header + mask + _xor_mask(data, mask))
        else:
            self.writer.write(header + data)
        await self.writer.drain()

    async def recv_message(self) -> tuple[int, bytes]:
        """-> (opcode, payload), reassembling fragmented messages."""
        message = bytearray()
        message_op = None
        compressed = False
        while True:
            b1, b2 = struct.unpack(">BB", await self.reader.readexactly(2))
            fin = b1 & 0x80
            opcode = b1 & 0x0F
            masked = b2 & 0x80
            length = b2 & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", await self.reader.readexactly(2))
            elif length == 127:
                (length,) = struct.unpack(">Q", await self.reader.readexactly(8))
            if opcode >= 0x8:
                # control frames: <=125 bytes and never fragmented (RFC
                # 6455 §5.5) — accepting a 5 MB PING and echoing a 5 MB
                # PONG is itself a violation compliant peers fail on; and
                # a control frame's length must NOT count against the
                # in-progress message budget (a legal ping near the cap
                # spuriously failed as 'too large')
                if length > 125 or not fin:
                    raise ValueError(
                        f"bad websocket control frame (op {opcode}, "
                        f"{length} bytes, fin={bool(fin)})")
            elif length > MAX_MESSAGE_SIZE or len(message) + length > MAX_MESSAGE_SIZE:
                raise ValueError(f"websocket frame too large ({length} bytes)")
            mask = await self.reader.readexactly(4) if masked else None
            payload = await self.reader.readexactly(length) if length else b""
            if mask:
                payload = _xor_mask(payload, mask)
            if opcode == OP_PING:
                await self.send_message(payload, OP_PONG)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self.closed = True
                # best-effort echo: drain() can raise RuntimeError
                # ('transport is closing') or OSError here, which escaped
                # as the wrong exception type past callers catching
                # ConnectionError for clean disconnect
                with contextlib.suppress(ConnectionError, OSError, RuntimeError):
                    await self.send_message(payload, OP_CLOSE)
                raise ConnectionError("websocket closed by peer")
            if opcode in (OP_TEXT, OP_BINARY):
                if message_op is not None:
                    # a new data frame while a fragmented message is in
                    # flight (RFC 6455 §5.4): silently dropping the partial
                    # lost half an ACIP packet and desynced the shared
                    # deflate window — fail the connection like the other
                    # framing violations
                    raise ValueError("websocket data frame interleaved "
                                     "with unfinished fragmented message")
                message_op = opcode
                message = bytearray(payload)
                compressed = bool(b1 & 0x40)  # RSV1 on the FIRST frame
                if compressed and not self.deflate:
                    raise ValueError("compressed frame without negotiated deflate")
            elif opcode == OP_CONT:
                if message_op is None:
                    # a continuation with nothing to continue (RFC 6455 §5.4)
                    raise ValueError("websocket continuation without start")
                message += payload
            else:
                # reserved opcodes (3-7, 11-15) MUST fail the connection
                # (RFC 6455 §5.2) — falling through would return a partial
                # fragmented message as if complete
                raise ValueError(f"reserved websocket opcode {opcode}")
            if fin:
                data = bytes(message)
                if compressed:
                    import zlib

                    try:
                        raw = self._rx.decompress(
                            data + b"\x00\x00\xff\xff", MAX_MESSAGE_SIZE + 1
                        )
                    except zlib.error as e:
                        # keep the documented bad-data contract: protocol
                        # violations surface as ValueError -> disconnect
                        raise ValueError(f"bad deflate stream: {e}") from e
                    if len(raw) > MAX_MESSAGE_SIZE:
                        raise ValueError("decompressed websocket message too large")
                    data = raw
                return message_op or OP_BINARY, data

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            with contextlib.suppress(ConnectionError, OSError, RuntimeError,
                                     asyncio.TimeoutError,
                                     asyncio.IncompleteReadError):
                # the polite CLOSE frame is best-effort and BOUNDED: a
                # stalled peer with full TCP buffers parks drain() forever,
                # which would hang every on_conn finally and leak the
                # connection — after 1 s just drop the socket
                await asyncio.wait_for(
                    self.send_message(struct.pack(">H", 1000), OP_CLOSE), 1.0)
        with contextlib.suppress(ConnectionError, OSError):
            self.writer.close()
            try:
                # the flush behind wait_closed() never finishes against a
                # stalled peer — bound it and abort(), like the TCP twin
                # (net/transport.py close): dropping undeliverable bytes IS
                # the disconnect semantics
                await asyncio.wait_for(self.writer.wait_closed(), timeout=2.0)
            except (TimeoutError, asyncio.TimeoutError):
                self.writer.transport.abort()


class WebSocketTransport(_QueuedSender):
    """ACIP-over-WebSocket with the net.transport.Transport interface.

    The queue/sender/send/send_nowait/close-drain machinery is SHARED with
    the TCP transport (net.transport._QueuedSender): the two used to be
    near-verbatim copies that drifted — the WS copy lost the dead-sender
    check and the bounded close() await, re-growing the hang/buffer-bloat
    bugs the TCP twin had already fixed."""

    def __init__(self, ws: WebSocketConnection):
        self.ws = ws
        self._init_sender()

    @property
    def peername(self):
        return self.ws.writer.get_extra_info("peername")

    async def _write_one(self, buf: bytes) -> None:
        await self.ws.send_message(buf)

    async def recv(self) -> tuple[int, bytes]:
        _, message = await self.ws.recv_message()
        if len(message) < pkt.HEADER_SIZE:
            raise ValueError("short websocket message")
        ptype, length, crc, _cid = pkt.unpack_header(message)
        payload = message[pkt.HEADER_SIZE : pkt.HEADER_SIZE + length]
        if len(payload) != length or not pkt.verify_payload(payload, crc):
            raise ValueError("websocket packet CRC mismatch")
        return ptype, payload

    async def close(self) -> None:
        await self._drain_sender()
        await self.ws.close()


def negotiate_deflate_offer(offered: str):
    """Server-side RFC 7692 §7 negotiation over the client's offer list.

    -> (accept, response_params, tx_wbits, tx_no_ctx). Parameters that
    constrain the CLIENT's compressor (client_max_window_bits with or
    without value, client_no_context_takeover) cost us nothing — a 15-bit
    context-takeover inflater decodes any smaller-window or per-message-
    reset stream — so they are accepted and omitted from the response
    (omission = no constraint requested back, §7.1.1). Parameters that
    constrain OUR compressor are honored and echoed: server_no_context_
    takeover resets the deflater per message, server_max_window_bits=N
    shrinks its window (zlib raw deflate needs N >= 9; N=8 declines this
    offer). Unknown parameters decline the offer (§7.1.3) — accepting
    while ignoring them is how streams get corrupted."""
    for part in offered.split(","):
        tokens = [p.strip() for p in part.split(";")]
        if not tokens or tokens[0] != "permessage-deflate":
            continue
        tx_wbits, tx_no_ctx = 15, False
        resp: list[str] = []
        ok = True
        for p in tokens[1:]:
            k, _, v = p.partition("=")
            k, v = k.strip(), v.strip().strip('"')
            if k in ("client_max_window_bits", "client_no_context_takeover"):
                continue
            if k == "server_no_context_takeover" and not v:
                tx_no_ctx = True
                resp.append(k)
            elif k == "server_max_window_bits":
                try:
                    n = int(v)
                except ValueError:
                    ok = False
                    break
                if not 9 <= n <= 15:
                    ok = False
                    break
                tx_wbits = n
                resp.append(f"server_max_window_bits={n}")
            else:
                ok = False
                break
        if ok:
            return True, "; ".join(["permessage-deflate", *resp]), tx_wbits, tx_no_ctx
    return False, "", 15, False


def parse_deflate_response(value: str):
    """Client-side: the server's agreed extension -> (accepted, tx_wbits,
    tx_no_ctx) for OUR compressor. client_max_window_bits=N in the
    response caps our window; client_no_context_takeover makes us reset
    per message. A response demanding something unsupportable, or carrying
    an unknown parameter, must FAIL THE HANDSHAKE (RFC 7692 §7.1): the
    server believes deflate is negotiated, so "speaking uncompressed" on
    our side still dies the moment the server sends its first compressed
    frame — raising here lets connect_ws fail cleanly instead."""
    accepted = False
    tx_wbits, tx_no_ctx = 15, False
    for part in value.split(","):
        tokens = [p.strip() for p in part.split(";")]
        if not tokens or not tokens[0]:
            continue
        if tokens[0] != "permessage-deflate":
            # the server selected an extension we never offered — its
            # framing would be applied to frames we can't interpret;
            # silently ignoring it deferred the failure to a confusing
            # mid-stream error instead of a clean handshake ConnectionError
            raise ConnectionError(
                f"server selected unoffered extension {tokens[0]!r}")
        if accepted:
            raise ConnectionError("duplicate permessage-deflate in response")
        accepted = True
        for p in tokens[1:]:
            k, _, v = p.partition("=")
            k, v = k.strip(), v.strip().strip('"')
            if k == "client_no_context_takeover":
                tx_no_ctx = True
            elif k == "client_max_window_bits" and v:
                try:
                    n = int(v)
                except ValueError:
                    raise ConnectionError(
                        f"bad deflate response param {p!r}") from None
                if not 9 <= n <= 15:
                    raise ConnectionError(
                        f"unsupportable deflate window {n}")
                tx_wbits = n
            elif k in ("client_max_window_bits",
                       "server_no_context_takeover",
                       "server_max_window_bits"):
                # server_* params describe the SERVER's compressor: our
                # 15-bit inflater handles anything; valueless
                # client_max_window_bits is a no-op hint
                continue
            else:
                raise ConnectionError(
                    f"unknown deflate response param {p!r}")
    # no early return: every listed extension is inspected, so a second
    # (unoffered) extension after permessage-deflate also fails
    return (accepted, tx_wbits, tx_no_ctx) if accepted else (False, 15, False)


async def connect_ws(host: str, port: int, path: str = "/",
                     deflate: bool = True,
                     handshake_timeout: float = 15.0) -> WebSocketTransport:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        ext = "Sec-WebSocket-Extensions: permessage-deflate\r\n" if deflate else ""
        writer.write(
            (
                f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n{ext}\r\n"
            ).encode()
        )
        await writer.drain()
        # bounded handshake: a server that accepts and never answers must
        # not park the client in readline() forever
        status, headers = await asyncio.wait_for(
            _read_http_headers(reader), handshake_timeout)
        if "101" not in status or headers.get("sec-websocket-accept") != _accept_key(key):
            raise ConnectionError(f"websocket handshake failed: {status}")
        negotiated, tx_wbits, tx_no_ctx = (False, 15, False)
        if deflate:
            negotiated, tx_wbits, tx_no_ctx = parse_deflate_response(
                headers.get("sec-websocket-extensions", ""))
    except BaseException:
        # a failed/timed-out handshake must not leak the socket (reconnect
        # loops would accumulate one fd per attempt)
        writer.close()
        raise
    t = WebSocketTransport(
        WebSocketConnection(reader, writer, is_client=True, deflate=negotiated,
                            tx_wbits=tx_wbits, tx_no_ctx=tx_no_ctx)
    )
    t.start_sender()
    return t


async def serve_ws(handler, host: str, port: int, pages=None,
                   post=None) -> asyncio.AbstractServer:
    """Listen for WebSocket upgrades; `await handler(WebSocketTransport)`.
    Plain HTTP GETs are routed through `pages(path) -> (ctype, body)|None`
    when provided (the browser app's static assets + JSON endpoints), else
    answered 400. POSTs route through `post(path, body) -> (ctype, body)|None`
    (awaitable results awaited) — the WebRTC signaling endpoint (browser
    offer -> SDP answer); without `post` a POST is answered 400. (The JAX
    package's `index_html` route has no caller here.)"""

    async def on_conn(reader, writer):
        try:
            # bounded header read: a slowloris peer (one byte a minute, or
            # nothing at all) must not hold an fd + task forever on the
            # public port
            status, headers = await asyncio.wait_for(
                _read_http_headers(reader), 15.0)
            key = headers.get("sec-websocket-key")
            # upgrade ONLY a real websocket handshake (RFC 6455 §4.2.1):
            # method GET + Upgrade: websocket. An h2c probe carrying a
            # stray Sec-WebSocket-Key used to be answered '101 ...
            # websocket' and handed to the ACIP handler.
            is_ws_upgrade = (
                key is not None and status.startswith("GET")
                and "upgrade" in headers.get("connection", "").lower()
                and "websocket" in headers.get("upgrade", "").lower())
            if not is_ws_upgrade:
                page = None
                if status.startswith("GET") and pages is not None:
                    page = pages(status.split(" ")[1] if " " in status else "/")
                elif status.startswith("POST") and post is not None:
                    path = status.split(" ")[1] if " " in status else "/"
                    clen = int(headers.get("content-length", "0"))
                    # the 15 s header bound does not cover the BODY: a
                    # slowloris POST declaring Content-Length and sending
                    # nothing held the fd + task forever on the public port
                    body = (await asyncio.wait_for(reader.readexactly(clen), 15.0)
                            if 0 < clen <= 1 << 20 else b"")
                    page = post(path, body)
                    if asyncio.iscoroutine(page):
                        page = await page
                if page is not None:
                    ctype, body = page
                    writer.write(
                        f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n".encode() + body
                    )
                elif status.startswith("GET") and pages:
                    writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n")
                else:
                    writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
                await writer.drain()
                writer.close()
                return
            # permessage-deflate (RFC 7692): negotiate honoring the offered
            # parameters (browsers offer it by default, so ASCII frames to
            # web clients compress even though those clients set the
            # no-zstd capability bit; an offer we can't honor is DECLINED
            # rather than accepted-and-ignored, which corrupts streams)
            offered = headers.get("sec-websocket-extensions", "")
            deflate, resp_params, tx_wbits, tx_no_ctx = (
                negotiate_deflate_offer(offered))
            ext = (f"Sec-WebSocket-Extensions: {resp_params}\r\n"
                   if deflate else "")
            writer.write(
                (
                    "HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n{ext}\r\n"
                ).encode()
            )
            await writer.drain()
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                asyncio.TimeoutError, ConnectionError, OSError, RuntimeError,
                ValueError):
            with contextlib.suppress(Exception):
                writer.close()
            return
        t = WebSocketTransport(
            WebSocketConnection(reader, writer, is_client=False, deflate=deflate,
                                tx_wbits=tx_wbits, tx_no_ctx=tx_no_ctx)
        )
        t.start_sender()
        try:
            await handler(t)
        finally:
            await t.close()

    return await asyncio.start_server(on_conn, host, port)
