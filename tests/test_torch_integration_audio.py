"""The port's command line end to end, the audio cases: two clients of
``python -m asciichat_tpu_torch.apps.main client`` exchange tones through a
server, all on the CPU, as the JAX package's tests/test_integration.py
cases ``test_opus_audio_duplex`` and ``test_mixed_codec_population`` do.
The helpers (bind(0) ports, waits under a deadline, children killed in a
``finally``) are test_torch_integration.py's; a file of its own spreads the
time over the test workers.

The clients' stdout is a pipe that nobody reads, as the JAX cases' spawn
makes it: their frame writes must not stop their audio (the display
thread, models/session.DisplayThread). Each wait for 96,000 samples in an
``--audio-out`` file fails at its deadline, naming the file. Skips: no
libopus.

On the CPU a tone client's capture chain (K5's plain version) takes longer
than the 10 ms frame it processes, so its tone reaches the others' mix in
10 ms bursts, the fewer the busier the machine; the server sends a mix
every 10 ms all the same. Where a case finds a tone's frequency, it reads
the mix ticks that carry sound, in order: the tone source keeps its phase
from frame to frame, so they are the tone as it was sent."""

import asyncio
import json

import numpy as np
import pytest

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import protocol as proto
from asciichat_tpu_torch.net.transport import connect_tcp
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime import codecs

from test_torch_integration import P, client, interrupt, run_async, start_server, until

SAMPLES = 96_000  # 2 s of 48 kHz mix in each file
TICK = 480  # samples of one mix tick, as the sink writes them


def wait_samples(path, procs: tuple) -> None:
    until(lambda: path.exists() and path.stat().st_size >= 4 * SAMPLES,
          f"{SAMPLES} samples in {path.name}", procs=procs)


def require_opus() -> None:
    try:
        codecs.OpusCodec()
    except codecs.CodecUnavailable:
        pytest.skip("no libopus")


def steady(path) -> np.ndarray:
    v = np.fromfile(path, "<f4")
    return v[len(v) // 2:]  # past the gate's attack and the ducking ramp


def test_opus_audio_duplex(tmp_path):
    """Two --opus clients: the server decodes each Opus uplink, mixes, and
    encodes each client's own exclude-self mix with that client's context.
    B hears A's tone; A does not hear itself."""
    require_opus()
    srv, port = start_server(tmp_path)
    fa, fb = tmp_path / "a.f32", tmp_path / "b.f32"
    procs = [srv]
    try:
        a = client(tmp_path, "a", port, "--no-media", "--tone-hz", "440", "--opus",
                   "--audio-out", str(fa), "--log-level", "WARNING")
        b = client(tmp_path, "b", port, "--no-media", "--tone-hz", "0", "--opus",
                   "--audio-out", str(fb), "--log-level", "WARNING")
        procs += [a, b]
        wait_samples(fb, (a, b))
        interrupt(a, b)
        vb, va = steady(fb), np.fromfile(fa, "<f4")
        rms_b = float(np.sqrt(np.mean(vb * vb)))
        rms_a = float(np.sqrt(np.mean(va * va))) if len(va) else 0.0
        assert rms_b > 0.02, f"B does not hear A's Opus tone (rms={rms_b})"
        assert rms_a < rms_b * 0.25, (rms_a, rms_b)
    finally:
        for p in procs:
            p.kill()


def test_mixed_codec_population(tmp_path):
    """One server, a mixed population: A uplinks Opus audio (and H.265
    video where an encoder exists), B raw PCM and raw RGB, and an in-process
    viewer watches. Every per-client decode feeds one batched tick; B's mix
    is dominated by A's 440 Hz (decoded from Opus) and A's by B's 220 Hz
    (raw), each through the exclude-self mixer. Both clients' stdout is an
    unread pipe, and both files still reach their 96,000 samples."""
    require_opus()
    try:
        codecs.H265Encoder(64, 48).close()
        h265 = ["--h265"]
    except codecs.CodecUnavailable:
        h265 = []  # still a mixed Opus / raw population
    srv, port = start_server(tmp_path)
    fa, fb = tmp_path / "a.f32", tmp_path / "b.f32"
    procs = [srv]
    try:
        a = client(tmp_path, "a", port, "--test-pattern", "--opus", *h265, "--tone-hz", "440",
                   "--audio-out", str(fa), "--width", "60", "--height", "20",
                   "--log-level", "WARNING")
        b = client(tmp_path, "b", port, "--test-pattern", "--tone-hz", "220",
                   "--audio-out", str(fb), "--width", "60", "--height", "20",
                   "--log-level", "WARNING")
        procs += [a, b]

        async def viewer():
            t = await connect_tcp("127.0.0.1", port)
            await t.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities(
                caps=TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
                width=80, height=24).pack())
            frames = streaming = 0
            try:
                while frames < 30 or streaming < 2:
                    ptype, payload = await asyncio.wait_for(t.recv(), 30)
                    if ptype == P.ASCII_FRAME:
                        frames += 1
                    elif ptype == P.SERVER_STATE:
                        streaming = max(streaming, json.loads(payload).get("streaming", 0))
                    elif ptype == P.PING:  # a silent viewer would be swept
                        await t.send(P.PONG, payload)
            finally:
                await t.close()
            return frames, streaming

        frames, streaming = run_async(viewer(), 90)
        assert frames >= 30 and streaming >= 2
        wait_samples(fb, (a, b))
        wait_samples(fa, (a, b))
        interrupt(a, b)

        def dominant_hz(path) -> float:
            v = np.fromfile(path, "<f4")
            ticks = v[len(v) // 2 // TICK * TICK:len(v) // TICK * TICK].reshape(-1, TICK)
            v = ticks[np.sqrt((ticks * ticks).mean(1)) > 0.01].reshape(-1)  # the sounding ticks
            assert len(v) >= 10 * TICK, f"{path.name}: {len(v) // TICK} ticks carry sound"
            spec = np.abs(np.fft.rfft(v * np.hanning(len(v))))
            spec[:3] = 0  # DC and the ducking envelope's drift
            return float(np.fft.rfftfreq(len(v), 1 / 48000)[int(np.argmax(spec))])

        hz_b, hz_a = dominant_hz(fb), dominant_hz(fa)
        assert abs(hz_b - 440) < 25, f"B's mix is dominated by {hz_b:.0f} Hz, not 440"
        assert abs(hz_a - 220) < 25, f"A's mix is dominated by {hz_a:.0f} Hz, not 220"
    finally:
        for p in procs:
            p.kill()
