"""The port's DataChannel stack on the CPU: DTLS over the system libssl
(asciichat_tpu_torch/net/dtls.py), SCTP and DCEP (net/sctp.py,
net/datachannel.py), the server's signaling (apps/webclient.WebRtcGateway
behind ``POST /webrtc/offer`` of ``server --ws-port``) and the client's
``use_webrtc``.

The JAX package's tests/test_datachannel.py runs here, all of it, on the
port's modules (``test_torch_webrtc.port_jax_tests``): its browser-role
and native-client cases drive the port's server and client. Then across
the packages: SCTP packets are equal bytes for the same inputs; the port's
client over WebRTC gets the oracle's frames from the JAX server and a JAX
client over WebRTC gets them from the port's server; a server whose
signaling is unavailable answers a POST as the JAX server does."""

import asyncio
import contextlib
import io
import os
import random
import socket
import struct

import pytest
import torch

from asciichat_tpu.net import sctp as jsctp
from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.net import dtls as tdtls
from asciichat_tpu_torch.net import sctp as tsctp

from conftest import synthetic_frame
from test_torch_client_app import _client, _quit, _shows, _Still
from test_torch_server_app import HB_TRUECOLOR, TERM_H, TERM_W, _oracle, _until
from test_torch_webrtc import port_jax_tests

LIMIT = 60.0  # seconds for any one socket test here


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tserver.AsciiChatServer, "_tune_latency", lambda self: None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


port_jax_tests(globals(), "test_datachannel.py")


needs_libssl = pytest.mark.skipif(not tdtls.available(),
                                  reason="OpenSSL 3 shared libraries not present")


# -- SCTP: the same packets from both packages -----------------------------------

def _sctp_script(sctp, monkeypatch, loss: float, peer=None) -> tuple[list, list, list]:
    """Connect, open a channel, send a fragmented message, 20 small ones and
    a reply, shut down: under a fake clock, a seeded loss pattern and
    ``os.urandom`` drawn from a seeded generator, so the run is a function
    of its inputs. The client is ``sctp``'s, the server ``peer``'s (default
    the same). Returns every packet on the wire, in order, and what each
    side received."""
    draws = random.Random(5)
    monkeypatch.setattr(os, "urandom", lambda n: draws.randbytes(n))
    # the one value the port changed (its receive window: see
    # test_sctp_window_holds_the_largest_packet), given to both
    monkeypatch.setattr(jsctp, "A_RWND", tsctp.A_RWND)
    peer = peer or sctp
    now, wire, qa, qb = [0.0], [], [], []
    a = sctp.SctpAssociation(qb.append, client=True, now_fn=lambda: now[0])
    b = peer.SctpAssociation(qa.append, client=False, now_fn=lambda: now[0])
    got_a, got_b = [], []
    a.on_message = lambda sid, ppid, data: got_a.append((sid, ppid, data))
    b.on_message = lambda sid, ppid, data: got_b.append((sid, ppid, data))
    drop = random.Random(9)

    def pump(iters: int = 3000) -> None:
        for _ in range(iters):
            for q, dst in ((qb, b), (qa, a)):
                while q:
                    packet = q.pop(0)
                    wire.append(packet)
                    if drop.random() >= loss:
                        dst.on_packet(packet)
            now[0] += 0.1
            a.tick()
            b.tick()
            if not (qa or qb or a._outstanding or b._outstanding or a._send_queue
                    or b._send_queue or a._hs_chunk or b._hs_chunk):
                return

    a.connect()
    pump()
    assert a.state == b.state == "established"
    sid = a.open_channel(label="acip")
    a.send(sid, sctp.PPID_BINARY, random.Random(1).randbytes(20_000))
    for i in range(20):
        a.send(sid, sctp.PPID_BINARY, b"m%03d" % i)
    b.send(sid, peer.PPID_BINARY, b"reply")
    pump()
    a.shutdown()
    pump()
    assert a.state == b.state == "done"
    return wire, got_a, got_b


@pytest.mark.parametrize("loss", [0.0, 0.2], ids=["clean", "lossy"])
def test_sctp_packets_equal_across_packages(loss, monkeypatch):
    ours = _sctp_script(tsctp, monkeypatch, loss)
    theirs = _sctp_script(jsctp, monkeypatch, loss)
    assert ours == theirs
    assert [m[2] for m in ours[2]][1:] == [b"m%03d" % i for i in range(20)]
    assert ours[1] == [(0, tsctp.PPID_BINARY, b"reply")]


@pytest.mark.parametrize("client", ["port", "jax"])
def test_sctp_association_across_packages(client, monkeypatch):
    """A port client with a JAX server, and the other way round, over the
    lossy wire: every message arrives, and the packets are those of a run
    within one package."""
    first, second = (tsctp, jsctp) if client == "port" else (jsctp, tsctp)
    assert (_sctp_script(first, monkeypatch, 0.2, peer=second)
            == _sctp_script(tsctp, monkeypatch, 0.2))


def _delivery_s(size: int, limit_s: float = 20.0) -> tuple[float, bool]:
    """Simulated seconds until one ``size``-byte message crosses a port
    association at a 10 ms round trip (``limit_s`` if it never does), and
    whether any DATA chunk was sent twice."""
    now, qa, qb = [0.0], [], []
    a = tsctp.SctpAssociation(qb.append, client=True, now_fn=lambda: now[0])
    b = tsctp.SctpAssociation(qa.append, client=False, now_fn=lambda: now[0])
    got, sent_tsns = [], []
    b.on_message = lambda sid, ppid, data: got.append(data)
    big = random.Random(2).randbytes(size)
    a.connect()
    for step in range(int(limit_s / 0.01)):
        if got:
            break
        if step == 5:
            assert a.state == b.state == "established"
            a.send(0, tsctp.PPID_BINARY, big)
        for q, dst in ((qb, b), (qa, a)):
            while q:
                packet = q.pop(0)
                if dst is b:
                    sent_tsns += [struct.unpack_from(">I", value)[0] for ctype, _, value
                                  in tsctp.unpack_packet(packet)[3] if ctype == tsctp.CT_DATA]
                dst.on_packet(packet)
        now[0] += 0.01
        a.tick()
        b.tick()
    assert got in ([], [big])
    return (now[0] if got else limit_s), len(sent_tsns) != len(set(sent_tsns))


@pytest.mark.parametrize("size", [800 * 600 * 3 + 22, tsctp.MAX_PACKET_SIZE],
                         ids=["image_frame_800x600", "max_packet"])
def test_sctp_window_holds_the_largest_packet(size, monkeypatch):
    """A message larger than the JAX package's 1 MiB window (an 800x600
    IMAGE_FRAME) and one of the largest ACIP packet arrive whole within 1 s
    of simulated time at a 10 ms round trip, with nothing resent: the
    window the port advertises holds them. With the JAX package's window
    in its place the 800x600 frame stalls past that (the receiver's window
    fills before the message is whole) and the largest packet never
    arrives."""
    assert tsctp.A_RWND >= tsctp.MAX_PACKET_SIZE + 64 * 1024 > jsctp.A_RWND
    took, resent = _delivery_s(size)
    assert took < 1.0 and not resent
    monkeypatch.setattr(tsctp, "A_RWND", jsctp.A_RWND)
    assert _delivery_s(size)[0] > 3.0


def test_sctp_packet_codec_equal_across_packages():
    chunks = tsctp._chunk(tsctp.CT_HEARTBEAT, 0, b"\x00\x01\x00\x08beat")
    assert chunks == jsctp._chunk(jsctp.CT_HEARTBEAT, 0, b"\x00\x01\x00\x08beat")
    packet = tsctp.pack_packet(5000, 5001, 0xDEADBEEF, chunks)
    assert packet == jsctp.pack_packet(5000, 5001, 0xDEADBEEF, chunks)
    assert tsctp.unpack_packet(packet) == jsctp.unpack_packet(packet)


# -- the client and server over WebRTC, across the packages -----------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _jax_client(port: int, frame):
    """The JAX package's client over WebRTC at the test geometry, frames
    uncompressed, keeping every displayed frame in ``client.shown``."""
    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.models.session import DisplaySink
    from asciichat_tpu.net import protocol as jproto

    wire = jproto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                   capabilities_mask=0x1)
    c = AsciiChatClient("127.0.0.1", port, _Still(frame), wire, reconnect=False,
                        use_webrtc=True)
    c.display = DisplaySink(stream=io.BytesIO())
    c.shown = []
    write = c.display.write_frame

    def keep(shown):
        c.shown.append(bytes(shown))
        write(shown)

    c.display.write_frame = keep
    return c


@needs_libssl
@pytest.mark.parametrize("server_side", ["jax", "port"],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_webrtc_client_and_server_across_packages(server_side, monkeypatch):
    """``server --ws-port`` of one package answers ``POST /webrtc/offer``
    from the other's client with ``use_webrtc``; the client's picture comes
    back as frames equal to the oracle's, over a DataChannel. The port's
    client quits with no error in a loop callback (the JAX client's quit key
    hands ``create_task`` the DataChannel's plain awaitable, a TypeError)."""
    from asciichat_tpu.apps import server as jserver

    monkeypatch.setattr(jserver.AsciiChatServer, "_tune_latency", lambda self: None)
    frame = synthetic_frame(48, 64, seed=41)
    want = _oracle([frame], "none")
    ws_port = _free_port()
    server_mod = jserver if server_side == "jax" else tserver

    loop_errors = []

    async def main():
        asyncio.get_running_loop().set_exception_handler(
            lambda loop, context: loop_errors.append(context))
        srv = server_mod.AsciiChatServer("127.0.0.1", 0, ws_port=ws_port)
        task = asyncio.create_task(srv.run())
        c = None
        try:
            await _until(lambda: _accepts(ws_port) or task.done(), "the ws listener")
            if task.done():
                task.result()
            c = (_client(ws_port, _Still(frame), use_webrtc=True) if server_side == "jax"
                 else _jax_client(ws_port, frame))
            run = asyncio.create_task(c.run())
            await _shows(c, want, "the picture over WebRTC")
            kinds = {type(cs.transport).__name__ for cs in srv.clients.values()}
            assert kinds == {"DataChannelTransport"}
            await _quit(c, run)
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
        return c

    c = asyncio.run(asyncio.wait_for(main(), 4 * LIMIT))
    assert c.frames_sent > 0
    if server_side == "jax":  # the client is the port's
        assert not loop_errors, loop_errors


def _accepts(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
        return True
    except OSError:
        return False


# -- a server without signaling answers a POST as the JAX server does -------------

async def _post(port: int, path: str, body: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}"
                 "\r\n\r\n".encode() + body)
    await writer.drain()
    status = await asyncio.wait_for(reader.readline(), LIMIT)
    writer.close()
    return status


@pytest.mark.parametrize("missing", ["libssl", "cryptography"])
def test_server_without_signaling_refuses_posts_as_the_jax_server(missing, monkeypatch):
    """Where DTLS (the JAX server's condition) or ``cryptography`` (the
    port's too) is unavailable, ``/webrtc/offer`` is not served: the port's
    server answers a POST with the status line the JAX server gives where
    DTLS is unavailable, and still serves the page."""
    import sys

    from asciichat_tpu.apps import server as jserver
    from asciichat_tpu.net import dtls as jdtls

    monkeypatch.setattr(jserver.AsciiChatServer, "_tune_latency", lambda self: None)
    monkeypatch.setattr(jdtls, "available", lambda: False)
    if missing == "libssl":
        monkeypatch.setattr(tdtls, "available", lambda: False)
    else:
        monkeypatch.setitem(sys.modules, "cryptography", None)

    async def status_lines(server_mod):
        ws_port = _free_port()
        srv = server_mod.AsciiChatServer("127.0.0.1", 0, ws_port=ws_port)
        task = asyncio.create_task(srv.run())
        try:
            await _until(lambda: _accepts(ws_port) or task.done(), "the ws listener")
            if task.done():
                task.result()
            got = [await _post(ws_port, "/webrtc/offer", b"v=0\r\n"),
                   await _post(ws_port, "/webrtc/candidate?ufrag=x", b"a=end-of-candidates")]
            reader, writer = await asyncio.open_connection("127.0.0.1", ws_port)
            writer.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            got.append(await asyncio.wait_for(reader.readline(), LIMIT))
            writer.close()
            return got
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    ours = asyncio.run(asyncio.wait_for(status_lines(tserver), 2 * LIMIT))
    assert ours == asyncio.run(asyncio.wait_for(status_lines(jserver), 2 * LIMIT))
    assert ours == [b"HTTP/1.1 400 Bad Request\r\n"] * 2 + [b"HTTP/1.1 200 OK\r\n"]
