"""The port's client (asciichat_tpu_torch/apps/client.py) on the CPU: in
process against the port's server in process over TCP, and scripted
transports for the session's edge cases.

Against the live server: the client's uploaded picture comes back as frames
byte-identical to the oracle (composite -> filter -> ascii convert), in the
clear and over an encrypted session; its tone (through the capture chain,
on the plain version: ASCIICHAT_TORCH_DEVICE=cpu) reaches another client,
with no failed audio frame; the command-line client prints oracle frames.
Scripted: a server's ERROR_MESSAGE surfaces as ServerError, repeated H.265
refusals latch the uplink off, and --no-reconnect gives up after the first
dial's retries. The rest mirrors the JAX client's cases
(tests/test_review_r04.py:2014-2194). No fixed sleeps: every wait polls for
its condition under a time limit."""

import asyncio
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu.net import packet as jpkt
from asciichat_tpu.net.transport import connect_tcp
from asciichat_tpu_torch.apps import client as client_mod
from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.apps.client import AsciiChatClient, ServerError
from asciichat_tpu_torch.models.session import DisplaySink
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import protocol as proto
from asciichat_tpu_torch.ops import audio, compositor
from asciichat_tpu_torch.render import oracle
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime.audiodev import ToneSource

from conftest import synthetic_frame
from test_torch_server_app import HB_TRUECOLOR, TERM_H, TERM_W, WAIT_S, _oracle, _run, _until

REPO = Path(__file__).resolve().parent.parent
P = pkt.PacketType


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tserver.AsciiChatServer, "_tune_latency", lambda self: None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Still:
    """A frame source that shows one picture, at most ``limit`` times."""

    def __init__(self, frame, limit: int = 10 ** 9):
        self.frame, self.left = frame, limit

    def read(self):
        self.left -= 1
        return self.frame if self.left >= 0 else None

    def close(self):
        pass


def _client(port: int, source=None, **kw) -> AsciiChatClient:
    """A port client at the test geometry, frames uncompressed, that keeps
    every displayed frame in ``client.shown``."""
    wire = proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                  capabilities_mask=0x1)
    c = AsciiChatClient("127.0.0.1", port, source, wire, reconnect=False, **kw)
    c.display = DisplaySink(stream=io.BytesIO())
    c.shown = []
    write = c.display.write_frame

    def keep(frame):
        c.shown.append(bytes(frame))
        write(frame)

    c.display.write_frame = keep
    return c


async def _shows(c: AsciiChatClient, want: bytes, what: str) -> None:
    await _until(lambda: want in c.shown, what)


async def _quit(c: AsciiChatClient, task) -> None:
    """The quit key, as the keyboard thread presses it; run() returns."""
    c._on_key("q")
    await asyncio.wait_for(task, WAIT_S)


def test_client_gets_oracle_frames():
    frame = synthetic_frame(48, 64, seed=21)

    async def body(srv):
        c = _client(srv.port, _Still(frame))
        task = asyncio.create_task(c.run())
        await _shows(c, _oracle([frame], "none"), "the client's own picture")
        await _quit(c, task)
        return c

    c = _run(body)
    assert c.frames_sent > 0 and c.audio_pipeline is None  # no audio: no device work


def test_client_tone_reaches_another_client():
    """The client's ToneSource goes through its capture chain (the plain
    version here) as AUDIO_BATCH; a raw listener hears it in its mix."""

    async def body(srv):
        c = _client(srv.port, audio_source=ToneSource(440.0, 0.2))
        assert c.audio_pipeline.device.type == "cpu"
        task = asyncio.create_task(c.run())
        await _until(lambda: len(srv.clients) == 1, "the client to register")
        t = await connect_tcp("127.0.0.1", srv.port)
        await t.send(jpkt.PacketType.CLIENT_CAPABILITIES,
                     proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                            capabilities_mask=0x1).pack())
        peaks = []
        end = asyncio.get_running_loop().time() + WAIT_S
        while not any(p > 0.05 for p in peaks):
            assert asyncio.get_running_loop().time() < end, peaks[-10:]
            ptype, payload = await asyncio.wait_for(t.recv(), WAIT_S)
            if ptype == jpkt.PacketType.AUDIO_BATCH:
                body_, _, total, _, _ = jpkt.unpack_audio_batch(payload)
                peaks.append(float(np.abs(np.frombuffer(body_, "<f4")[:total]).max()))
        await t.close()
        await _quit(c, task)
        return c, max(peaks)

    c, peak = _run(body)
    assert 0.05 < peak <= 0.25
    assert c.audio_frames_sent > 0 and c.audio_failures == 0


def test_encrypted_session():
    pytest.importorskip("cryptography")
    frame = synthetic_frame(48, 64, seed=22)

    async def body(srv):
        c = _client(srv.port, _Still(frame), encrypt=True, password="sekrit")
        task = asyncio.create_task(c.run())
        await _shows(c, _oracle([frame], "none"), "the encrypted client's picture")
        await _quit(c, task)

    _run(body, password="sekrit")


def test_cli_client_prints_oracle_frames(tmp_path):
    """``python -m asciichat_tpu_torch.apps.main client`` with a picture on
    stdin, against the server in process: exits 0 after --max-frames, the
    last frame byte-identical to the oracle."""
    frame = synthetic_frame(48, 64, seed=23)
    feed = tmp_path / "frames.rgb"
    feed.write_bytes(frame.tobytes() * 600)  # 20 s at 30 fps: outlasts the run

    async def body(srv):
        cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "client", "127.0.0.1",
               "--port", str(srv.port), "--stdin-size", "64x48", "--no-compress",
               "--no-reconnect", "--max-frames", "30", "--width", str(TERM_W), "--height",
               str(TERM_H), "--render-mode", "2", "--color-mode", "truecolor",
               "--log-level", "WARNING"]
        env = dict(os.environ, OMP_NUM_THREADS="1", COLORTERM="truecolor", LANG="C.UTF-8")
        with open(feed, "rb") as stdin:
            proc = await asyncio.create_subprocess_exec(
                *cmd, cwd=REPO, env=env, stdin=stdin, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
            out, err = await asyncio.wait_for(proc.communicate(), 3 * WAIT_S)
        return proc.returncode, out, err

    rc, out, err = _run(body)
    assert rc == 0, err.decode(errors="replace")[-3000:]
    # piped stdout: the client asks for frames without padding
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK,
                                wants_padding=False, utf8_support=True)
    comp = compositor.composite_reference(
        frame[None], compositor.plan_composite([(64, 48)], TERM_W, TERM_H))
    want = oracle.ascii_convert_with_capabilities(comp, TERM_W, 2 * TERM_H, caps)
    assert out.endswith(want + b"\n"), err.decode(errors="replace")[-2000:]


# ---- scripted sessions ------------------------------------------------------


class _Scripted:
    """A transport that delivers ``script`` (ptype, payload) pairs, then
    ends the stream; what is sent is recorded."""

    def __init__(self, script=()):
        self.script = list(script)
        self.sent = []
        self.closed = False

    async def recv(self):
        if not self.script:
            raise asyncio.IncompleteReadError(b"", 1)
        ptype, payload = self.script.pop(0)
        return ptype, payload

    async def send(self, ptype, payload=b"", **kw):
        self.sent.append(int(ptype))

    def send_nowait(self, ptype, payload=b"", **kw):
        self.sent.append(int(ptype))

    async def close(self):
        self.closed = True


def _connect_to(monkeypatch, t):
    async def fake_connect(host, port):
        return t

    monkeypatch.setattr(client_mod, "connect_tcp", fake_connect)


def test_server_error_surfaces(monkeypatch):
    """A terminal ERROR_MESSAGE (SERVER_FULL) ends run() with ServerError,
    never a reconnect."""
    _connect_to(monkeypatch, _Scripted([(int(P.ERROR_MESSAGE), proto.pack_error(1, "full"))]))
    c = _client(1)
    c.reconnect_policy.enabled = True
    with pytest.raises(ServerError) as e:
        asyncio.run(asyncio.wait_for(c.run(), WAIT_S))
    assert e.value.code == 1 and e.value.msg == "full"


def test_h265_refusal_latches(monkeypatch):
    """The server advertises H.265, then refuses it (once per in-flight
    frame): the uplink falls back to raw RGB, duplicates are ignored, and a
    later SERVER_STATE does not switch it back on."""
    state = json.dumps({"codecs": ["h265"]}).encode()
    refusal = proto.pack_error(int(proto.WireError.CODEC_UNAVAILABLE), "no decoder")
    t = _Scripted([(int(P.SERVER_STATE), state), (int(P.ERROR_MESSAGE), refusal),
                   (int(P.ERROR_MESSAGE), refusal), (int(P.SERVER_STATE), state)])
    c = _client(1, want_h265=True)
    seen = []
    real = t.recv

    async def watch():
        seen.append(c.h265_active)
        return await real()

    t.recv = watch
    with pytest.raises(asyncio.IncompleteReadError):
        asyncio.run(asyncio.wait_for(c._recv_loop(t, None), WAIT_S))
    assert seen == [False, True, False, False, False]
    assert not c.h265_active and not c.want_h265 and not c._stop.is_set()


def test_no_reconnect_gives_up():
    """Nothing listens: the first dial retries briefly, then run() raises
    with --no-reconnect."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    c = _client(port)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        asyncio.run(asyncio.wait_for(c.run(), WAIT_S))
    assert time.monotonic() - t0 < 10


def test_audio_failure_is_counted_and_skipped():
    """A frame the capture chain fails on is logged, counted and skipped;
    the task goes on to the next frame."""
    c = _client(1, audio_source=ToneSource(440.0, 0.2))
    calls = {"n": 0}
    real = c.audio_pipeline.process

    def flaky(frame):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("injected capture fault")
        return real(frame)

    c.audio_pipeline.process = flaky
    t = _Scripted()

    async def run():
        task = asyncio.create_task(c._audio_capture_task(t))
        await _until(lambda: c.audio_frames_sent >= 2, "two frames after the faults")
        c._stop.set()
        await asyncio.wait_for(task, WAIT_S)

    asyncio.run(run())
    assert c.audio_failures == 2 and t.sent.count(int(P.AUDIO_BATCH)) == c.audio_frames_sent


def test_audio_pipeline_is_built_only_for_an_audio_source(monkeypatch):
    """A client without audio does no device work and needs no card; with
    audio and no card named, the default device (the card) is required."""
    monkeypatch.delenv("ASCIICHAT_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert AsciiChatClient("127.0.0.1", 1, reconnect=False).audio_pipeline is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsciiChatClient("127.0.0.1", 1, reconnect=False, audio_source=ToneSource())
    c = AsciiChatClient("127.0.0.1", 1, reconnect=False, audio_source=ToneSource(),
                        device="cpu")
    assert isinstance(c.audio_pipeline, audio.ClientAudioPipeline)


def test_client_capture_task_closes_encoder_after_fallback():
    class _Enc:
        closed = False

        def close(self):
            self.closed = True

    c = _client(1, _Still(np.zeros((8, 8, 3), np.uint8), limit=1))
    enc = _Enc()
    c._h265_enc = enc
    c.h265_active = False  # the recv loop already fell back
    asyncio.run(asyncio.wait_for(c._capture_task(_Scripted()), WAIT_S))
    assert enc.closed and c._h265_enc is None


def test_client_h265_fallback_closes_encoder_on_encode_error():
    class _Enc:
        width, height = 8, 8
        closed = False

        def encode(self, frame):
            raise ValueError("avcodec_send_frame -1")

        def close(self):
            self.closed = True

    c = _client(1)
    enc = _Enc()
    c._h265_enc = enc
    c.h265_active = True
    c._send_h265(_Scripted(), np.zeros((8, 8, 3), np.uint8))
    assert not c.h265_active and enc.closed and c._h265_enc is None


def test_client_session_resets_dead_link_clock(monkeypatch):
    _connect_to(monkeypatch, _Scripted())
    c = _client(1)
    c._last_rx = time.monotonic() - 100  # stale from a dead previous session
    with pytest.raises(asyncio.IncompleteReadError):
        asyncio.run(asyncio.wait_for(c._session(None), WAIT_S))
    assert time.monotonic() - c._last_rx < 10


def test_client_caches_argon2_password_key(monkeypatch):
    pytest.importorskip("cryptography")
    from asciichat_tpu_torch.net import crypto, handshake

    derivations = {"n": 0}

    def fake_set_password(self, password):
        derivations["n"] += 1
        self.password_key = b"k" * 32

    async def fake_handshake(*a, **kw):
        return False  # proceed unencrypted

    monkeypatch.setattr(crypto.CryptoContext, "set_password", fake_set_password)
    monkeypatch.setattr(handshake, "client_handshake", fake_handshake)
    c = _client(1, encrypt=True, password="hunter2")

    async def run_twice():
        for _ in range(2):
            _connect_to(monkeypatch, _Scripted())
            with pytest.raises(asyncio.IncompleteReadError):
                await c._session(None)

    asyncio.run(asyncio.wait_for(run_twice(), WAIT_S))
    assert derivations["n"] == 1


def test_client_quit_key_marshals_to_loop():
    async def run():
        c = _client(1)
        c._loop = asyncio.get_running_loop()
        threading.Thread(target=c._on_key, args=("q",)).start()
        await _until(c._stop.is_set, "the quit key", 10)
        return True

    assert asyncio.run(run())


def test_client_keys_toggle_flip_and_overlays():
    c = _client(1)
    for key in ("f", "?", "s"):
        c._on_key(key)
    assert c.transform.flip_x and c.display.show_help and c.display.show_fps
    c._on_key("f")
    assert not c.transform.flip_x


def test_client_default_caps_populate_fps_meta():
    c = AsciiChatClient("127.0.0.1", 1, reconnect=False)
    key, size = c.display._meta
    assert key != "" and size != (0, 0)


def test_request_resize_sends_size_message():
    c = _client(1)
    t = _Scripted()
    c._live_transport = t
    c.request_resize(100, 30)
    assert (c.wire_caps.width, c.wire_caps.height) == (100, 30)
    assert t.sent == [int(P.SIZE_MESSAGE)]


def test_upload_is_fit_to_800x600():
    c = _client(1)
    big = synthetic_frame(900, 1600, seed=2)
    out = c.transform(big)
    assert out.shape == (450, 800, 3)
