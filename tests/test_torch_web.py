"""The port's standard-library transports on the CPU: the WebSocket transport
(asciichat_tpu_torch/net/websocket.py), mDNS (net/mdns.py), the browser
page (web/, apps/webclient.py) and the server's ``ws_port`` and ``mdns`` with
the client's ``use_ws``.

The JAX package's WebSocket tests (tests/test_net_extras.py:11,41,105,181)
run on the port's modules, and a JAX client talks to the port's server and a
port client to the JAX server. The mDNS codec and name compression
(:61,73); an announcer and ``discover`` round trip, and the server's
``/servers.json``, over an in-process stand-in for the multicast group
(``_Bus``), so no datagram leaves the process. Every file under
``asciichat_tpu_torch/web/`` is byte-equal to the JAX package's (but for one
comment of app.js, ``COPY_EDITS``). The port's
server with a ``ws_port`` and its client with ``use_ws=True``, in process:
the frames received equal the oracle's; ``ws_port=0`` serves no WebSocket.
Every socket wait runs under ``asyncio.wait_for`` with a limit of its own."""

import asyncio
import json
import queue
import socket
import struct
import threading
from pathlib import Path

import pytest
import torch

from asciichat_tpu.net import websocket as jws
from asciichat_tpu_torch import web
from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.net import mdns
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import websocket as tws

from conftest import synthetic_frame
from test_torch_client_app import _client, _quit, _shows, _Still
from test_torch_server_app import _oracle, _run, _until

REPO = Path(__file__).resolve().parent.parent
LIMIT = 30.0  # seconds for any one socket test


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tserver.AsciiChatServer, "_tune_latency", lambda self: None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# -- WebSocket framing (tests/test_net_extras.py on the port) -----------------------

def test_websocket_echo_roundtrip():
    async def run():
        got = []

        async def handler(t):
            ptype, payload = await t.recv()
            got.append((ptype, payload))
            await t.send(pkt.PacketType.PONG, payload)
            # big payload crosses the 64KB extended-length encoding
            await t.send(pkt.PacketType.ASCII_FRAME, b"x" * 70_000)
            await asyncio.sleep(0.2)

        server = await tws.serve_ws(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await tws.connect_ws("127.0.0.1", port)
        await t.send(pkt.PacketType.PING, b"hello-ws")
        assert await t.recv() == (pkt.PacketType.PONG, b"hello-ws")
        ptype, payload = await t.recv()
        assert ptype == pkt.PacketType.ASCII_FRAME and len(payload) == 70_000
        await t.close()
        server.close()
        assert got == [(pkt.PacketType.PING, b"hello-ws")]

    asyncio.run(asyncio.wait_for(run(), LIMIT))


@pytest.mark.parametrize("request_head", [
    b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",
    # serve_ws without a `post` route (no WebRTC signaling) refuses the offer
    b"POST /webrtc/offer HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\nv=",
], ids=["get", "post"])
def test_websocket_rejects_non_upgrade(request_head):
    async def run():
        async def handler(t):
            pass

        server = await tws.serve_ws(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(request_head)
        await writer.drain()
        assert b"400" in await reader.readline()
        writer.close()
        server.close()

    asyncio.run(asyncio.wait_for(run(), LIMIT))


def test_websocket_oversized_frame_rejected():
    """A claimed multi-GB frame, and fragments that add up past the cap, are
    refused before they are read."""
    async def run():
        class W:  # writer never used before the raise
            def get_extra_info(self, *_):
                return None

        reader = asyncio.StreamReader()
        reader.feed_data(struct.pack(">BBQ", 0x82, 127, 8 << 30))
        with pytest.raises(ValueError):
            await tws.WebSocketConnection(reader, W(), is_client=False).recv_message()
        reader2 = asyncio.StreamReader()
        half = tws.MAX_MESSAGE_SIZE // 2 + 100
        reader2.feed_data(struct.pack(">BBQ", 0x02, 127, half) + b"a" * half)
        reader2.feed_data(struct.pack(">BBQ", 0x80, 127, half) + b"b" * half)
        with pytest.raises(ValueError):
            await tws.WebSocketConnection(reader2, W(), is_client=False).recv_message()
        assert tws.MAX_MESSAGE_SIZE == pkt.MAX_PACKET_SIZE + pkt.HEADER_SIZE

    asyncio.run(asyncio.wait_for(run(), LIMIT))


def test_websocket_permessage_deflate():
    """RFC 7692 negotiated and used both ways; a client that does not offer
    it stays uncompressed."""
    async def run():
        got, negotiated = [], []

        async def handler(t):
            negotiated.append(t.ws.deflate)
            for _ in range(2 if t.ws.deflate else 1):
                ptype, payload = await t.recv()
                got.append(payload)
                await t.send(pkt.PacketType.ASCII_FRAME, payload)
            await asyncio.sleep(0.2)

        server = await tws.serve_ws(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await tws.connect_ws("127.0.0.1", port)
        assert t.ws.deflate
        body = b"\x1b[38;2;1;2;3mX" * 5000
        sent_sizes = []
        orig_write = t.ws.writer.write
        t.ws.writer.write = lambda b: (sent_sizes.append(len(b)), orig_write(b))
        for _ in range(2):
            await t.send(pkt.PacketType.ASCII_FRAME, body)
            assert (await t.recv())[1] == body
        assert got == [body, body]
        assert max(sent_sizes) < len(body) // 4, sent_sizes
        await t.close()
        t2 = await tws.connect_ws("127.0.0.1", port, deflate=False)
        assert not t2.ws.deflate
        await t2.send(pkt.PacketType.ASCII_FRAME, body)
        assert (await t2.recv())[1] == body
        await t2.close()
        server.close()
        assert negotiated == [True, False]

    asyncio.run(asyncio.wait_for(run(), LIMIT))


@pytest.mark.parametrize("server_side, client_side", [(tws, jws), (jws, tws)],
                         ids=["jax-client-port-server", "port-client-jax-server"])
@pytest.mark.parametrize("deflate", [True, False], ids=["deflate", "plain"])
def test_websocket_interoperates_with_the_jax_package(server_side, client_side, deflate):
    body = b"\x1b[38;2;9;8;7m#" * 3000

    async def run():
        async def handler(t):
            ptype, payload = await t.recv()
            await t.send(pkt.PacketType.ASCII_FRAME, payload[::-1])
            await t.send(pkt.PacketType.PONG, b"")
            await asyncio.sleep(0.2)

        server = await server_side.serve_ws(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await client_side.connect_ws("127.0.0.1", port, deflate=deflate)
        assert t.ws.deflate == deflate
        await t.send(pkt.PacketType.IMAGE_FRAME, body)
        assert await t.recv() == (pkt.PacketType.ASCII_FRAME, body[::-1])
        assert await t.recv() == (pkt.PacketType.PONG, b"")
        await t.close()
        server.close()

    asyncio.run(asyncio.wait_for(run(), LIMIT))


# -- mDNS -------------------------------------------------------------------------

def test_mdns_message_codec():
    ann = mdns.build_announcement("myhost", 27224, {"ver": "1"}, "192.168.1.7")
    svc = mdns.parse_response(ann, "192.168.1.7")
    assert svc is not None
    assert svc.instance == "myhost" and svc.port == 27224
    assert svc.address == "192.168.1.7" and svc.txt == {"ver": "1"}
    assert mdns.parse_response(mdns.build_query(), "1.2.3.4") is None


def test_mdns_name_compression():
    raw = b"\x00" * 12 + mdns._encode_name("foo.local")
    name, _ = mdns._decode_name(raw + b"\xc0\x0c", len(raw))
    assert name == "foo.local"


def test_mdns_codec_matches_the_jax_package():
    from asciichat_tpu.net import mdns as jmdns

    args = ("srv", 27224, {"ver": "1", "ws": "8080", "name": "café"}, "192.0.2.1")
    assert mdns.build_announcement(*args) == jmdns.build_announcement(*args)
    assert mdns.build_query() == jmdns.build_query()


class _Bus:
    """An in-process stand-in for the mDNS multicast group: each datagram
    sent reaches every open socket of the bus, the sender's too (multicast
    loopback). No datagram leaves the process."""

    def __init__(self):
        self.sockets: list[_BusSocket] = []
        self.lock = threading.Lock()

    def socket(self) -> "_BusSocket":
        s = _BusSocket(self)
        with self.lock:
            self.sockets.append(s)
        return s


class _BusSocket:
    def __init__(self, bus: _Bus):
        self.bus, self.inbox, self.timeout = bus, queue.Queue(), None

    def settimeout(self, timeout):
        self.timeout = timeout

    def sendto(self, data, addr):
        with self.bus.lock:
            for s in self.bus.sockets:
                s.inbox.put((bytes(data), ("127.0.0.1", mdns.MDNS_PORT)))

    def recvfrom(self, n):
        try:
            return self.inbox.get(timeout=self.timeout)
        except queue.Empty:
            raise socket.timeout from None

    def close(self):
        with self.bus.lock:
            self.bus.sockets.remove(self)


@pytest.fixture
def bus(monkeypatch):
    b = _Bus()
    monkeypatch.setattr(mdns, "_mdns_socket", b.socket)
    monkeypatch.setattr(mdns, "_lan_address", lambda: "127.0.0.1")
    return b


def test_mdns_announcer_answers_discover(bus):
    announcer = mdns.MdnsAnnouncer("asciichat", 27224, {"ver": "1", "ws": "8080"})
    announcer.start()
    try:
        asyncio.run(asyncio.wait_for(
            _until(lambda: len(bus.sockets) == 1, "the announcer's socket", LIMIT), LIMIT))
        found = mdns.discover(timeout=1.0)
    finally:
        announcer.stop()
    assert [(s.instance, s.address, s.port, s.txt) for s in found] == [
        ("asciichat", "127.0.0.1", 27224, {"ver": "1", "ws": "8080"})]
    assert not announcer._thread.is_alive() and not bus.sockets


# -- the browser page ---------------------------------------------------------------

# jsrun.py, the JS engine runner, is the port's own module over
# kernel_build.native_lib, not a byte copy; tests/test_torch_tail.py runs the
# JAX package's JS tests through it
WEB_FILES = sorted(p.name for p in (REPO / "asciichat_tpu_torch" / "web").iterdir()
                   if p.is_file() and p.name != "jsrun.py")
# the one edit of the copies: app.js's line 17, a comment that named where
# a checkout kept the reference's tree, names the tree alone
COPY_EDITS = {"app.js": {16: b" * (the reference's web/ test scripts; "
                             b"src/web/main_wasm.c:1-37).\n"}}


@pytest.mark.parametrize("name", WEB_FILES)
def test_web_file_is_a_byte_copy(name):
    want = (REPO / "asciichat_tpu" / "web" / name).read_bytes().splitlines(keepends=True)
    for line, text in COPY_EDITS.get(name, {}).items():
        assert b"web/ test scripts" in want[line]
        want[line] = text
    assert (REPO / "asciichat_tpu_torch" / "web" / name).read_bytes() == b"".join(want)


def test_web_files_are_the_assets_and_the_parser():
    assert set(WEB_FILES) == {f for _, f in web.ASSETS.values()} | {"__init__.py", "ansiparse.py"}


async def _http_get(port: int, path: str) -> tuple[str, dict, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    status = (await reader.readline()).decode()
    headers = {}
    while (line := await reader.readline()) not in (b"\r\n", b""):
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    body = await reader.readexactly(int(headers.get("content-length", 0)))
    writer.close()
    return status, headers, body


async def _listening(port: int) -> None:
    """Wait until ``port`` accepts: the server opens its WebSocket listener
    after its TCP one."""
    end = asyncio.get_running_loop().time() + LIMIT
    while True:
        try:
            _, writer = await asyncio.open_connection("127.0.0.1", port)
        except OSError:
            assert asyncio.get_running_loop().time() < end, f"nothing listens on {port}"
            await asyncio.sleep(0.02)
            continue
        writer.close()
        return


# -- the port's server and client over WebSocket ----------------------------------------

def test_client_over_websocket_gets_oracle_frames():
    frame = synthetic_frame(48, 64, seed=31)
    ws_port = _free_port()

    async def body(srv):
        await _listening(ws_port)
        c = _client(ws_port, _Still(frame), use_ws=True)
        task = asyncio.create_task(c.run())
        await _shows(c, _oracle([frame], "none"), "the picture over WebSocket")
        assert type(next(iter(srv.clients.values())).transport).__name__ == "WebSocketTransport"
        await _quit(c, task)
        return c

    c = _run(body, ws_port=ws_port)
    assert c.frames_sent > 0


def test_server_serves_the_page_and_announces_itself(bus):
    """Every route of ``web.ASSETS`` returns the port's file bytes; the
    server's mDNS announcement comes back through ``/servers.json``."""
    ws_port = _free_port()

    async def body(srv):
        await _listening(ws_port)
        for route, (ctype, name) in web.ASSETS.items():
            status, headers, data = await _http_get(ws_port, route)
            assert "200" in status and headers["content-type"] == ctype, route
            assert data == (REPO / "asciichat_tpu_torch" / "web" / name).read_bytes(), route
        assert "404" in (await _http_get(ws_port, "/no-such-page"))[0]
        roster = []
        end = asyncio.get_running_loop().time() + LIMIT
        while not roster:
            assert asyncio.get_running_loop().time() < end, "no server in /servers.json"
            status, headers, data = await _http_get(ws_port, "/servers.json")
            assert "200" in status and headers["content-type"] == "application/json"
            roster = json.loads(data)
            assert isinstance(roster, list)
            await asyncio.sleep(0.1)
        return roster, srv.port

    roster, port = _run(body, ws_port=ws_port, mdns=True)
    assert roster == [{"name": "asciichat", "host": "127.0.0.1", "port": port,
                       "ws": str(ws_port)}]
    assert not bus.sockets  # the announcer closed its socket at shutdown


@pytest.mark.parametrize("ws_port", [0, None], ids=["zero", "none"])
def test_ws_port_zero_serves_no_websocket(ws_port, monkeypatch):
    calls = []
    monkeypatch.setattr(tws, "serve_ws", lambda *a, **k: calls.append(a))

    async def body(srv):
        await asyncio.sleep(0.2)
        return srv.ws_port

    assert _run(body, ws_port=ws_port) == ws_port
    assert calls == []


def test_port_corpus_generator_reproduces_the_committed_corpus(tmp_path, monkeypatch):
    """tools/torch_gen_ansi_corpus.py (the port's oracle and ANSI parser)
    gives tests/data/ansi_corpus.json byte for byte, here without writing
    it; its ``main`` writes those bytes."""
    import importlib.util

    path = REPO / "tools" / "torch_gen_ansi_corpus.py"
    spec = importlib.util.spec_from_file_location("torch_gen_ansi_corpus", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    committed = REPO / "tests" / "data" / "ansi_corpus.json"
    assert gen.dumps(gen.corpus()).encode() == committed.read_bytes()
    out = tmp_path / "data" / "ansi_corpus.json"
    monkeypatch.setattr(gen, "OUT", str(out))
    gen.main()
    assert out.read_bytes() == committed.read_bytes()
