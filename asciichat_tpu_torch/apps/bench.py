"""The port's benchmark: 1080p -> 203x64 truecolor ASCII conversion on the
card, byte-gated, with the server tick and the overlapped serving pipeline.

Counterpart of the repository's root ``bench.py`` (the JAX package's), run as

    python -m asciichat_tpu_torch.apps.main bench

on ``ASCIICHAT_TORCH_DEVICE`` (``cuda`` by default; ``cpu`` runs the plain
versions). ``ASCIICHAT_BENCH_SMOKE=1`` takes the JAX script's tiny shapes
(B=8 frames of 270x480; server sources of 160x120) on the same device, to
check every stage end to end; its numbers are not measurements and its JSON
says ``"smoke": true``. Stages, in the JAX script's order:

1. frames: the synthetic gradient of ``bench.py:86-95``, built on the device;
2. the byte gate: two frames' records (K2) -> host -> the native emitter
   must equal ``render/oracle.ascii_convert_with_capabilities``; a mismatch
   prints the JSON line with ``value`` 0.0 and exits 1;
3. the timed conversion: ``render_cells`` (K2) launched k times inside one
   CUDA graph, for k = 8 and 40, each loop's best of 3 replays timed with
   CUDA events on its own, the difference over 32 iterations (3 retries,
   then the 40-loop's raw rate with a WARNING). The JAX loop's
   ``frames + (acc & 1)`` serial dependency is not carried over: eager
   launches are never merged or hoisted, and in eager torch that add would
   rewrite the whole batch every iteration. ``eager_convert_fps`` is what a
   host loop of 40 launches sustains;
4. the host emitter on 32 frames' records, one thread, then several;
5. the overlapped pipeline (``runtime/device_stream.py``): the convert
   stage replays a graph of 24 conversions and hands on a copy of the last
   one's records, the fetch stage copies 8 frames' records to pinned
   memory, the emit stage emits them, all at once for 6 s after 1.5 s of
   warm-up;
6. the server tick: nine 800x600 sources, nine receivers with the JAX
   script's filters at 203x64 half-block truecolor, and the exclude-self
   mix, one ``tick_compute`` (K3 + K4) a tick, differenced over graphs of 8
   and 40 ticks. A fault here ends the run: nothing is caught;
7. the DataChannel: 55 KB ACIP frames over ``net/webrtc.IceLiteAgent``
   (ICE, DTLS 1.2, SCTP) on loopback, the only stage that may be skipped,
   when libssl or ``cryptography`` is missing (its key is then null and the
   reason goes to stderr).

One JSON line goes to stdout, everything else to stderr. Its keys are the
JAX script's, with ``hlo_fingerprint`` replaced by ``kernel_fingerprint``
(the digest of the kernel library's sources and flags,
``runtime/kernel_build.library_digest``), and ``server_tick_rate`` (ticks/s)
and ``eager_convert_fps`` added. ``versions`` names torch, CUDA, the
device and, on a card, its power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from asciichat_tpu_torch.models import server
from asciichat_tpu_torch.ops import cells
from asciichat_tpu_torch.render import emitter, oracle
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import plan_render
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime import kernel_build
from asciichat_tpu_torch.runtime.device import default_device
from asciichat_tpu_torch.runtime.device_stream import OverlappedRenderPipeline

METRIC = "1080p_truecolor_ascii_fps_per_chip"
NORTH_STAR_FPS = 10_000.0  # BASELINE.json: conversions per second on one chip
TERM_W, TERM_H = 203, 64
FG_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
HB_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
LOOPS = (8, 40)  # the differenced loop lengths (conversions or ticks)
REPS = 3  # best of, for each loop length on its own
RETRIES = 3  # differencing attempts before the raw rate
GATE_FRAMES = 2
EMIT_FRAMES, EMIT_ITERS, EMIT_REPS = 32, 8, 5
PIPELINE_K, FETCH_SLICE = 24, 8
PIPELINE_S, PIPELINE_WARMUP_S = 6.0, 1.5
SERVER_FILTERS = ["none", "green", "cyan", "none", "orange", "none", "pink", "none",
                  "rainbow"]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class DataChannelUnavailable(RuntimeError):
    """The DataChannel stage cannot run on this machine (no libssl 3, or no
    ``cryptography``)."""


def make_frames(b: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """uint8 [b, h, w, 3] on ``device``: ``bench.py``'s gradient (R along x
    + 7 a frame, G along y + 13 a frame, B = x + y + 29 a frame, mod 256),
    one channel at a time; the third in uint8, whose sums wrap mod 256."""
    bidx = torch.arange(b, dtype=torch.int32, device=device)
    xx = torch.arange(w, dtype=torch.int32, device=device)
    yy = torch.arange(h, dtype=torch.int32, device=device)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=device)
    out[..., 0] = ((xx * 255) // (w - 1))[None, None, :].add(7 * bidx[:, None, None]) % 256
    out[..., 1] = ((yy * 255) // (h - 1))[None, :, None].add(13 * bidx[:, None, None]) % 256
    u8 = torch.uint8
    out[..., 2] = ((xx % 256).to(u8)[None, None, :] + (yy % 256).to(u8)[None, :, None]
                   + ((29 * bidx) % 256).to(u8)[:, None, None])
    return out


def seconds(fn, cuda: bool) -> float:
    """Seconds that one call of ``fn`` takes: CUDA events around it on the
    card (the device's time from its first launch to its last), the host
    clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def loop(fn, k: int, cuda: bool, start=lambda: None):
    """A callable that runs ``start()`` and then ``fn`` k times, and returns
    the last call's result: one replay of a CUDA graph of the k calls on the
    card (``fn`` must not copy from the host; one eager call runs first, on
    a side stream, so that what it uploads is resident; the result is the
    graph's own output, which the next replay overwrites), a Python loop on
    the CPU. ``start`` resets what the calls carry from one to the next, so
    that every run begins alike."""
    if not cuda:
        def run():
            start()
            for _ in range(k):
                out = fn()
            return out
        return run
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        start()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    start()  # the graph reads what start() holds, which outlives it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            out = fn()

    def replay():
        graph.replay()
        return out

    return replay


def differenced(fn, cuda: bool, what: str, start=lambda: None) -> float:
    """Seconds per call of ``fn`` by the JAX script's method: loops of
    LOOPS[0] and LOOPS[1] calls, each loop's best of REPS runs on its own,
    their difference per extra call; RETRIES attempts, then the long loop's
    raw time per call (launch overhead included: a lower bound on the
    rate), with a WARNING."""
    k1, k2 = LOOPS
    short, long_ = loop(fn, k1, cuda, start), loop(fn, k2, cuda, start)
    best1 = best2 = float("inf")
    for attempt in range(RETRIES):
        for _ in range(REPS):
            best1 = min(best1, seconds(short, cuda))
            best2 = min(best2, seconds(long_, cuda))
        if best2 - best1 > 0:
            log(f"{what}: k{k1}={best1 * 1e3:.4f} ms k{k2}={best2 * 1e3:.4f} ms, "
                f"best-of-{REPS}")
            return (best2 - best1) / (k2 - k1)
        log(f"{what}: jitter-corrupted differencing pair (k{k1}={best1 * 1e3:.4f} ms >= "
            f"k{k2}={best2 * 1e3:.4f} ms); retrying ({attempt + 1}/{RETRIES})")
    log(f"WARNING: {what}: differencing never converged; reporting the k{k2} loop's "
        "raw rate (launch overhead included -> lower bound)")
    return best2 / k2


def card_versions(dev: torch.device) -> dict:
    versions = {"torch": torch.__version__, "cuda": torch.version.cuda,
                "platform": dev.type if dev.type == "cpu" else "gpu"}
    if dev.type == "cuda":
        versions["device"] = torch.cuda.get_device_name(dev)
        smi = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        versions["power_limit"] = (smi.stdout.strip().split(",")[-1].strip()
                                   if smi.returncode == 0 else None)
    return versions


def zero_line() -> str:
    return json.dumps({"metric": METRIC, "value": 0.0, "unit": "frames/s",
                       "vs_baseline": 0.0})


def main() -> int:
    smoke = os.environ.get("ASCIICHAT_BENCH_SMOKE") == "1"
    try:
        dev = default_device()
    except RuntimeError as e:
        print(f"bench: {e}; set ASCIICHAT_TORCH_DEVICE=cpu to run the plain versions",
              file=sys.stderr)
        return 1
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    versions = card_versions(dev)
    log(f"device: {dev}" + (" [SMOKE MODE]" if smoke else ""))
    log(f"versions: {versions}")

    b = 8 if smoke else 128
    src_h, src_w = (270, 480) if smoke else (1080, 1920)
    plan = plan_render(src_w, src_h, TERM_W, TERM_H, FG_TRUECOLOR)
    log(f"plan: {plan}")
    frames = make_frames(b, src_h, src_w, dev)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    tables = cells.cell_tables(src_h, src_w, plan.dst_h_px, plan.dst_w, dev) if cuda else None

    def convert(f=frames, r=ramp):
        return cells.render_cells(f, r, dst_h=plan.dst_h_px, dst_w=plan.dst_w,
                                  mode=plan.mode, tables=tables)

    def emit(host, nthreads=1):
        return emitter.emit_frames(host, plan.mode, pal.DEFAULT_PALETTE, pad_w=plan.pad_w,
                                   pad_h=plan.pad_h, nthreads=nthreads, copy=False)

    # --- byte-exactness gate on a slice of the batch ----------------------
    records = convert()
    got = emitter.emit_frames(
        cells.records_to_numpy({k: v[:GATE_FRAMES] for k, v in records.items()}),
        plan.mode, pal.DEFAULT_PALETTE, pad_w=plan.pad_w, pad_h=plan.pad_h)
    frames_h = frames[:GATE_FRAMES].cpu().numpy()
    for i in range(GATE_FRAMES):
        want = oracle.ascii_convert_with_capabilities(frames_h[i], TERM_W, TERM_H,
                                                      FG_TRUECOLOR)
        if bytes(got[i]) != want:
            log(f"FATAL: frame {i} is not byte-identical to the oracle")
            print(zero_line(), flush=True)
            return 1
    log(f"byte-exactness gate: OK (frame bytes={len(got[0])})")

    # --- timed conversion -------------------------------------------------
    fingerprint = kernel_build.library_digest()
    log(f"kernel library fingerprint: {fingerprint}")
    per_iter = differenced(convert, cuda, "device conversion")
    fps = b / per_iter
    log(f"device conversion: {fps:,.0f} frames/s ({per_iter / b * 1e6:.3f} us/frame)")
    k2 = LOOPS[1]
    eager = min(seconds(loop(convert, k2, False), cuda) for _ in range(REPS))
    eager_fps = b * k2 / eager
    log(f"eager conversion (a host loop of {k2} launches): {eager_fps:,.0f} frames/s")

    # --- host emitter in isolation (worst-case content: SGR every cell) ----
    nslice = min(EMIT_FRAMES, b)
    hb = cells.records_to_numpy({k: v[:nslice] for k, v in records.items()})
    emit(hb)
    best = float("inf")
    for _ in range(EMIT_REPS):
        t0 = time.perf_counter()
        for _ in range(EMIT_ITERS):
            out = emit(hb)
        best = min(best, time.perf_counter() - t0)
    emit_fps = nslice * EMIT_ITERS / best
    frame_bytes = sum(len(o) for o in out) // len(out)
    log(f"host emitter (isolated, 1 thread, {frame_bytes} B/frame): {emit_fps:,.0f} frames/s")
    nthreads_mt = min(4, max(2, os.cpu_count() or 1))
    best_mt = float("inf")
    for _ in range(EMIT_REPS):
        t0 = time.perf_counter()
        for _ in range(EMIT_ITERS):
            emit(hb, nthreads_mt)
        best_mt = min(best_mt, time.perf_counter() - t0)
    emit_fps_mt = nslice * EMIT_ITERS / best_mt
    log(f"host emitter ({nthreads_mt} threads on {os.cpu_count()} cores): "
        f"{emit_fps_mt:,.0f} frames/s ({emit_fps_mt / emit_fps:.2f}x)")

    # --- overlapped pipeline: convert || D2H || emit ----------------------
    convert_k = loop(convert, PIPELINE_K, cuda)

    def step_records(_frames, _ramp):  # the frames and ramp that convert_k was made with
        # a copy: the fetch reads these records while the next replay overwrites the graph's
        return {k: v.clone() for k, v in convert_k().items()}

    pipe = OverlappedRenderPipeline(step_records, frames, ramp, emit, batch=b, k=PIPELINE_K,
                                    fetch_slice=FETCH_SLICE)
    rates = pipe.run(seconds=PIPELINE_S, warmup=PIPELINE_WARMUP_S)
    # the emit stage re-renders the latest fetched slice, so its rate is the
    # stage's under full concurrency, not distinct frames; distinct frames
    # on this box are the slowest of the three, and the projection leaves
    # out the copy (the records' PCIe rate is far above either other stage's)
    emit_conc = rates["emit_fps"]
    onbox = min(rates["convert_fps"], rates["d2h_fps"], rates["emit_fps"])
    projection = min(rates["convert_fps"], rates["emit_fps"])
    log(f"overlapped pipeline ({rates['seconds']:.1f} s, all 3 stages concurrent): "
        f"convert={rates['convert_fps']:,.0f} fps, d2h={rates['d2h_fps']:,.0f} fps "
        f"({rates['d2h_mbps']:.1f} MB/s), emit={emit_conc:,.0f} fps")
    log(f"end to end on this box (min of the concurrent stages): {onbox:,.0f} frames/s; "
        f"projection min(convert, emit): {projection:,.0f}")

    # --- the 9-client server tick (K3 + K4) --------------------------------
    tick_rate = 1.0 / bench_server_tick(dev, smoke)
    log(f"9-client server tick (composite + 9 personalised renders + 9 exclude-self "
        f"mixes): {tick_rate:,.1f} ticks/s (reference cadence: 60/s)")

    # --- the WebRTC DataChannel transport ---------------------------------
    try:
        datachannel_fps = bench_datachannel()
        log(f"WebRTC DataChannel loopback (DTLS 1.2 + SCTP, both endpoints here): "
            f"{datachannel_fps:,.0f} x 55 KB ACIP frames/s")
    except DataChannelUnavailable as e:
        log(f"datachannel skipped: {e}")
        datachannel_fps = None

    print(json.dumps({
        "metric": METRIC,
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / NORTH_STAR_FPS,
        "eager_convert_fps": eager_fps,
        "emit_under_concurrency_fps": emit_conc,
        "end_to_end_onbox_fps": onbox,
        "end_to_end_pcie_projection_fps": projection,
        "host_emit_fps": emit_fps,
        "host_emit_fps_mt": emit_fps_mt,
        "host_emit_mt_threads": nthreads_mt,
        "pipeline_convert_fps": rates["convert_fps"],
        "pipeline_d2h_fps": rates["d2h_fps"],
        "pipeline_d2h_mbps": rates["d2h_mbps"],
        "server_tick_rate": tick_rate,
        "kernel_fingerprint": fingerprint,
        "datachannel_fps": datachannel_fps,
        "versions": versions,
        **({"smoke": True} if smoke else {}),
    }), flush=True)
    return 0


def bench_server_tick(dev: torch.device, smoke: bool) -> float:
    """Seconds per 9-client tick: the composite gather from nine uploads,
    nine personalised half-block renders and nine exclude-self mixes, one
    ``server.tick_compute`` (K3 + K4 on the card) a tick with the mixer
    state carried, differenced like the conversion."""
    c = len(SERVER_FILTERS)
    src_w, src_h = (160, 120) if smoke else (800, 600)
    plan = server.plan_tick([(src_w, src_h)] * c, term_w=TERM_W, term_h=TERM_H,
                            caps=HB_TRUECOLOR)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (c, src_h, src_w, 3), dtype=np.uint8)).to(dev)
    audio = torch.from_numpy(rng.normal(0, 0.1, (c, 480)).astype(np.float32)).to(dev)
    active = torch.ones(c, dtype=torch.bool, device=dev)
    tick = server.ServerTick(plan, client_filters=SERVER_FILTERS, device=dev)
    r = plan.render
    state = [tick.mixer_state]

    def start():
        state[0] = tick.mixer_state  # every run starts from the same state

    def one_tick():
        _records, _mixes, state[0] = server.tick_compute(
            frames, audio, active, state[0], *tick.consts, mode=r.mode, dst_h=r.dst_h_px,
            dst_w=r.dst_w)

    return differenced(one_tick, dev.type == "cuda", "server tick", start)


def bench_datachannel() -> float:
    """55 KB ACIP frames through the negotiated WebRTC stack (ICE
    nomination, DTLS 1.2, SCTP/DCEP) over loopback, both endpoints in this
    process (so about half the rate of one endpoint per host): frames/s."""
    import asyncio

    from asciichat_tpu_torch.net import dtls as dtls_mod

    if not dtls_mod.available():
        raise DataChannelUnavailable("OpenSSL 3 is not available")
    try:
        import cryptography  # noqa: F401  (the ICE agent's X25519 keys)
    except ImportError as e:
        raise DataChannelUnavailable(f"cryptography does not import: {e}") from None

    async def run() -> float:
        from asciichat_tpu_torch.net.webrtc import IceLiteAgent

        a = IceLiteAgent(controlling=True, dtls=True)
        b = IceLiteAgent(controlling=False, dtls=True)
        await a.start("127.0.0.1")
        await b.start("127.0.0.1")
        try:
            b.set_remote(a.local_description())
            a.set_remote(b.local_description())
            ch_a = await (await a.wait_connected(15)).wait_ready(15)
            ch_b = await (await b.wait_connected(15)).wait_ready(15)
            frame = os.urandom(55_000)
            n = 120

            async def producer():
                for _ in range(n):
                    await ch_a.send(3000, frame)

            t0 = time.perf_counter()
            prod = asyncio.create_task(producer())
            try:
                for _ in range(n):
                    await asyncio.wait_for(ch_b.recv(), 30)
                return n / (time.perf_counter() - t0)
            finally:
                # a receive timeout must not abandon the producer mid-send:
                # its exception says which side stalled
                if not prod.done():
                    prod.cancel()
                try:
                    await prod
                except (asyncio.CancelledError, ConnectionError) as e:
                    log(f"datachannel producer ended: {e!r}")
        finally:
            a.close()
            b.close()

    return asyncio.run(asyncio.wait_for(run(), 60))
