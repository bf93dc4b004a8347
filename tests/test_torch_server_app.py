"""The port's live server (asciichat_tpu_torch/apps/server.py) on the CPU,
in-process, at a free port, against raw ACIP clients over TCP: each
receiver's ASCII_FRAME is byte-identical to the oracle (composite_reference
-> apply_color_filter_reference -> ascii_convert_with_capabilities), the
audio mixes exclude each speaker's own voice, the stack's high-watermark can
grow mid-session, a failed device tick is skipped (nothing is rendered on the
host), an encrypted session works, and an auth option without
``cryptography`` refuses to start. No fixed sleeps: every wait polls for its
condition under a time limit."""

import asyncio
import contextlib
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu.net import packet as pkt
from asciichat_tpu.net import protocol as proto
from asciichat_tpu.net.transport import connect_tcp
from asciichat_tpu.render import oracle
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.models.server import RecordArena
from asciichat_tpu_torch.ops import compositor, filters

from conftest import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
P = pkt.PacketType
HB_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
TERM_W, TERM_H = 40, 12
WAIT_S = 60.0  # limit for any one condition


@pytest.fixture(autouse=True)
def _cpu_server(monkeypatch):
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    # the latency tuning freezes gc and changes the switch interval for the
    # whole process: not in a test worker
    monkeypatch.setattr(tserver.AsciiChatServer, "_tune_latency", lambda self: None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


async def _until(cond, what: str, limit: float = WAIT_S):
    """Poll ``cond()`` (sync) until it is true, or fail after ``limit`` s."""
    loop = asyncio.get_running_loop()
    end = loop.time() + limit
    while not cond():
        if loop.time() > end:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def _run(body, **server_kwargs):
    """Start the port's server on a free port, run ``await body(srv)``, stop."""

    async def main():
        srv = tserver.AsciiChatServer("127.0.0.1", 0, **server_kwargs)
        task = asyncio.create_task(srv.run())
        try:
            await _until(lambda: srv._server is not None or task.done(), "listening")
            if task.done():
                task.result()
            return await asyncio.wait_for(body(srv), 4 * WAIT_S)
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    return asyncio.run(main())


def _wire(color_filter: str = "none", term=(TERM_W, TERM_H)) -> proto.WireCapabilities:
    # bit 0 of capabilities_mask: frames arrive uncompressed (no zstandard)
    return proto.WireCapabilities(caps=HB_TRUECOLOR, width=term[0], height=term[1],
                                  capabilities_mask=0x1,
                                  color_filter=filters.FILTER_NAMES.index(color_filter))


async def _join(srv, n_before: int, wire: proto.WireCapabilities, frame=None):
    """Connect, send caps (and a frame), and wait until the server holds the
    client, so the source order is the join order."""
    t = await connect_tcp("127.0.0.1", srv.port)
    await t.send(P.CLIENT_CAPABILITIES, wire.pack())
    if frame is not None:
        await t.send(P.IMAGE_FRAME, pkt.pack_image_frame(
            frame.tobytes(), frame.shape[1], frame.shape[0]))
    await _until(lambda: len(srv.clients) == n_before + 1, "the client to register")
    return t


def _oracle(frames: list[np.ndarray], name: str, term=(TERM_W, TERM_H)) -> bytes:
    """A receiver's expected bytes: the composite of ``frames`` at the
    receiver's geometry, filtered, through the oracle."""
    sizes = [(f.shape[1], f.shape[0]) for f in frames]
    stack = np.zeros((len(frames), max(f.shape[0] for f in frames),
                      max(f.shape[1] for f in frames), 3), np.uint8)
    for i, f in enumerate(frames):
        stack[i, :f.shape[0], :f.shape[1]] = f
    comp = compositor.composite_reference(stack, compositor.plan_composite(sizes, *term))
    return oracle.ascii_convert_with_capabilities(
        filters.apply_color_filter_reference(comp, name), term[0], 2 * term[1], HB_TRUECOLOR)


async def _frame_equal(t, want: bytes, what: str) -> None:
    """Read ASCII_FRAMEs until one equals ``want`` (earlier ones may be of
    an earlier layout), under the time limit."""
    loop = asyncio.get_running_loop()
    end = loop.time() + WAIT_S
    last = None
    while loop.time() < end:
        try:
            ptype, payload = await asyncio.wait_for(t.recv(), end - loop.time())
        except TimeoutError:
            break
        if ptype == P.ASCII_FRAME:
            last = pkt.unpack_ascii_frame(payload)[0]
            if last == want:
                return
    raise AssertionError(f"{what}: no frame equal to the oracle "
                         f"(last frame {None if last is None else len(last)} bytes)")


def _frames(sizes, seed):
    return [synthetic_frame(h, w, seed=seed + i) for i, (w, h) in enumerate(sizes)]


def test_clients_get_oracle_frames():
    names = ["none", "green", "none", "cyan"]
    frames = _frames([(64, 48), (48, 64), (80, 60), (40, 30)], seed=1)

    async def body(srv):
        ts = [await _join(srv, i, _wire(n), f)
              for i, (n, f) in enumerate(zip(names, frames))]
        for i, (t, name) in enumerate(zip(ts, names)):
            await _frame_equal(t, _oracle(frames, name), f"client {i} ({name})")
        state = srv.server_state()
        for t in ts:
            await t.close()
        return state

    state = _run(body)
    assert state["device"] == "cpu" and state["mesh"] is None
    assert state["tick_compute"] > 0 and state["device_failures"] == 0
    assert state["render_launches"] == 0  # on the CPU the plain render runs


def test_audio_excludes_self():
    tone = (0.5 * np.sin(np.arange(480) / 7)).astype("<f4")
    silence = np.zeros(480, "<f4")

    async def body(srv):
        speaker = await _join(srv, 0, _wire())
        quiet = await _join(srv, 1, _wire())
        heard, own_peak = [], []

        async def listen(t, into):
            while True:
                ptype, payload = await t.recv()
                if ptype == P.AUDIO_BATCH:
                    body, _, total, _, _ = pkt.unpack_audio_batch(payload)
                    into.append(float(np.abs(np.frombuffer(body, "<f4")[:total]).max()))

        tasks = [asyncio.create_task(listen(speaker, own_peak)),
                 asyncio.create_task(listen(quiet, heard))]
        try:
            # talk until the quiet client has heard the tone and the speaker
            # has had ten mixes of its own (mixes come only while audio arrives)
            loop = asyncio.get_running_loop()
            end = loop.time() + WAIT_S
            while not (any(p > 0.01 for p in heard) and len(own_peak) >= 10):
                assert loop.time() < end, (heard, own_peak)
                await speaker.send(P.AUDIO_BATCH, pkt.pack_audio_batch(tone.tobytes(), 480, 1))
                await quiet.send(P.AUDIO_BATCH, pkt.pack_audio_batch(silence.tobytes(), 480, 1))
                await asyncio.sleep(0.01)
        finally:
            for task in tasks:
                task.cancel()
        await speaker.close()
        await quiet.close()
        return heard, own_peak, srv.server_state()

    heard, own_peak, state = _run(body)
    assert max(heard) > 0.01  # the quiet client hears the tone
    assert max(own_peak) < 1e-6  # the speaker's own voice is excluded
    assert state["mixer_launches"] == 0  # on the CPU the plain mixer runs
    assert state["audio_tick_latency"]["n"] >= len(own_peak)
    assert state["audio_failures"] == 0


def test_stack_high_watermark_grows_mid_session():
    """A larger source joins (the padded stack grows) and leaves; the
    remaining clients keep getting oracle frames from the device path."""
    small = _frames([(40, 30), (48, 36)], seed=5)
    large = synthetic_frame(90, 120, seed=9)

    async def body(srv):
        a = await _join(srv, 0, _wire("none"), small[0])
        b = await _join(srv, 1, _wire("green"), small[1])
        await _frame_equal(a, _oracle(small, "none"), "before the join")
        hwm0 = srv._stack_hwm
        c = await _join(srv, 2, _wire("cyan"), large)
        await _frame_equal(b, _oracle(small + [large], "green"), "with the large source")
        hwm1 = srv._stack_hwm
        await c.close()
        await _until(lambda: len(srv.clients) == 2, "the large client to leave")
        await _frame_equal(a, _oracle(small, "none"), "after the leave")
        await _frame_equal(b, _oracle(small, "green"), "after the leave")
        state = srv.server_state()
        await a.close()
        await b.close()
        return hwm0, hwm1, srv._stack_hwm, state

    hwm0, hwm1, hwm2, state = _run(body)
    assert hwm0 == (2, 36, 48) and hwm1 == (3, 90, 120) and hwm2 == hwm1
    assert state["device_failures"] == 0


def test_two_terminal_sizes_render_in_one_call_per_tick(monkeypatch):
    """Clients of two terminal sizes form two geometry groups: each client
    gets its oracle bytes, and every tick renders both groups with one
    render_groups call (on a card that call is one K3 launch, counted by
    chip_smoke.py)."""
    calls: list[tuple[int, int]] = []  # (the server's tick count, groups)
    real = tserver.render_groups
    frames = _frames([(64, 48), (40, 30)], seed=14)
    small = (30, 10)

    async def body(srv):
        def counted(frames_dev, groups, *args, **kwargs):
            calls.append((srv.ticks, len(groups)))
            return real(frames_dev, groups, *args, **kwargs)

        monkeypatch.setattr(tserver, "render_groups", counted)
        a = await _join(srv, 0, _wire("none"), frames[0])
        b = await _join(srv, 1, _wire("green", small), frames[1])
        await _frame_equal(a, _oracle(frames, "none"), "client 0 (40x12)")
        await _frame_equal(b, _oracle(frames, "green", small), "client 1 (30x10)")
        state = srv.server_state()
        await a.close()
        await b.close()
        return state

    state = _run(body)
    ticks = [t for t, _ in calls]
    assert len(set(ticks)) == len(ticks)  # never two render calls in one tick
    assert max(n for _, n in calls) == 2  # both groups in one call
    assert state["device_failures"] == 0


# the device step of a tick, and its fetch
FAULT_TARGETS = {"step": (tserver, "render_groups"), "fetch": (RecordArena, "fetch")}


@pytest.mark.parametrize("stage", ["step", "fetch"])
def test_device_fault_skips_the_tick(monkeypatch, stage):
    """A tick whose device work fails (at the launch or at the fetch) is
    skipped, never rendered on the host: no frame goes out while the fault
    holds, every failure counts on the inspector, and the traceback is
    logged at ERROR. Once the fault clears, the next tick re-uploads the
    stack and serves oracle frames."""
    fault = {"on": True}
    owner, name = FAULT_TARGETS[stage]
    real = getattr(owner, name)

    def flaky(*args, **kwargs):
        if fault["on"]:
            raise RuntimeError("injected device fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, flaky)
    frames = _frames([(64, 48), (40, 30)], seed=12)
    records: list[logging.LogRecord] = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("asciichat.server")
    logger.addHandler(handler)

    async def body(srv):
        a = await _join(srv, 0, _wire("green"), frames[0])
        b = await _join(srv, 1, _wire("none"), frames[1])
        await _until(lambda: srv.device_failures >= 3, "three failed ticks")
        during = (srv.stats.frames_sent, srv.stats.frames_rendered,
                  srv.tick_compute_count)
        fault["on"] = False
        await _frame_equal(a, _oracle(frames, "green"), f"{stage}: client 0")
        await _frame_equal(b, _oracle(frames, "none"), f"{stage}: client 1")
        await a.close()
        await b.close()
        return during, srv.server_state()

    try:
        during, state = _run(body)
    finally:
        logger.removeHandler(handler)
    errors = [r for r in records if r.levelno == logging.ERROR
              and "device render tick failed" in r.getMessage()]
    assert during == (0, 0, 0)  # nothing rendered or sent while failing
    assert errors and errors[0].exc_info is not None
    assert state["device_failures"] >= 3 and state["tick_compute"] > 0


def test_encrypted_session():
    from asciichat_tpu.net.crypto import CryptoContext
    from asciichat_tpu.net.handshake import SecureChannel, client_handshake

    frame = synthetic_frame(48, 64, seed=3)

    async def body(srv):
        raw = await connect_tcp("127.0.0.1", srv.port)
        ctx = CryptoContext()
        ctx.set_password("sekrit")
        assert await client_handshake(raw, ctx, "sekrit")
        t = SecureChannel(raw, ctx, initiator=True)
        await t.send(P.CLIENT_CAPABILITIES, _wire("green").pack())
        await t.send(P.IMAGE_FRAME, pkt.pack_image_frame(frame.tobytes(), 64, 48))
        await _frame_equal(t, _oracle([frame], "green"), "encrypted client")
        await raw.close()

    _run(body, password="sekrit")


def test_auth_option_without_cryptography_refuses_to_start():
    code = ("import sys; sys.modules['cryptography'] = None; sys.modules['jax'] = None; "
            "from asciichat_tpu_torch.apps.main import main; "
            "sys.exit(main(['server', '--port', '0', '--password', 'x']))")
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr[-2000:]
    assert "cryptography" in out.stderr and "listening" not in out.stderr
