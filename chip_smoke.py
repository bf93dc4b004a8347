#!/usr/bin/env python3
"""Drive the PyTorch port's render path once on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It imports no JAX. The phases run in order and any failure raises,
so the exit code is non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``asciichat_tpu_torch/csrc`` (nvcc);
3. K1 (resize) against its plain version, bit-exact, at the mirror's
   1080p -> 57x203 geometry and at odd shapes;
4. ``render_cells`` (K2; K1 for the two half-block RGB modes) against the
   plain ``records_for_mode`` for all 10 modes, bit-exact;
5. K3 (server render) against the plain ``render_compute`` at the server's
   geometry: 9 sources of 800x600 -> 203x64, per-receiver filters;
6. mirror: ``AsciiRenderer.convert_batch`` on 128 frames of 1080p, byte-exact
   against the oracle, and the mirror CLI's ``--snapshot`` in a subprocess;
7. server: ``RenderGroup.step`` for 100 ticks, every receiver's bytes against
   the oracle;
8. the kernels' launch counts over phases 6-7 (each must be > 0) and their
   times against the plain versions, as one JSON line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Comparisons are exact (tolerance 0): every record is uint8.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from asciichat_tpu.render import emitter, oracle, palette
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu.runtime.framesource import TestPatternSource
from asciichat_tpu_torch.models import server
from asciichat_tpu_torch.ops import cells, compositor, filters, pixel, resize
from asciichat_tpu_torch.render.pipeline import AsciiRenderer, plan_render
from asciichat_tpu_torch.runtime import kernel_build
from asciichat_tpu_torch.runtime.device import require_cuda

ROOT = Path(__file__).resolve().parent

SRC_H, SRC_W, BATCH = 1080, 1920, 128  # the mirror convert's cell (bench.py)
TERM_W, TERM_H = 203, 64
SERVER_SOURCES = 9  # MAX_COMPOSITE_SOURCES
UPLINK_W, UPLINK_H = 800, 600  # the server's uplink cap (apps/server.py:45)
SERVER_FILTERS = ["none", "green", "cyan", "none", "orange", "none", "pink",
                  "none", "rainbow"]
SERVER_TICKS = 100
ODD_RESIZES = [((48, 64), (12, 40)), ((37, 53), (20, 31)), ((16, 16), (40, 80)),
               ((240, 320), (57, 203))]

FG_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
HB_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
FG_256 = TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND)

KERNELS = (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL,
           server.RENDER_GROUP_KERNEL)

CARD = ""  # "name, power limit" of the card, set in phase 1


def say(msg: str) -> None:
    print(msg, flush=True)


def make_frames(b: int, h: int, w: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """uint8 [b, h, w, 3] on ``device``: per-frame gradients plus noise
    from numpy (eight noise planes, reused cyclically)."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(
        rng.integers(0, 32, (min(b, 8), h, w, 3), dtype=np.uint8)).to(device)
    yy = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(b):
        r = (xx * 255 // max(w - 1, 1) + 7 * i).expand(h, w)
        g = (yy * 255 // max(h - 1, 1) + 13 * i).expand(h, w)
        bl = xx + yy + 29 * i
        base = torch.stack([r, g, bl], dim=-1)
        out[i] = ((base + noise[i % noise.shape[0]]) % 256).to(torch.uint8)
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``, replayed from one CUDA graph
    of ``iters`` calls: the time the card spends, without the host's
    launch cost. ``fn`` must not copy from the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over a tensor or a record dict; raises on any
    difference of keys, shapes or dtypes."""
    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"record keys {list(got)} != {list(want)}")
        return max(max_abs_err(got[k], want[k]) for k in want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item())


def check_exact(label: str, got, want, errs: list[int]) -> None:
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    errs.append(err)
    if err != 0:
        raise AssertionError(f"{label}: max abs err {err}, expected 0")
    say(f"  ok  {label}: bit-exact")


def timing(label: str, kernel_ms: float, plain_ms: float, device_ms=None) -> None:
    graph = "" if device_ms is None else f" (device only, CUDA graph: {device_ms:.4f} ms)"
    say(f"  time {label}: kernel {kernel_ms:.4f} ms{graph}, plain {plain_ms:.4f} ms "
        f"[{CARD}]")


def phase1_device() -> torch.device:
    global CARD
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    for line in lines:
        say(line)
    CARD = lines[0].strip()
    say(f"phase 1: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return dev


def phase2_build() -> None:
    t0 = time.monotonic()
    path, log = kernel_build.build_cuda(verbose=True)
    kernel_build.cuda_lib()
    say(f"phase 2: built {path.relative_to(ROOT)} in "
        f"{time.monotonic() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas {line.strip()}")


def phase3_resize(dev, frames: torch.Tensor, errs: list[int]) -> tuple[float, float]:
    say("phase 3: K1 resize vs plain")
    plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, FG_TRUECOLOR)
    dh, dw = plan.dst_h_px, plan.dst_w
    for b in (8, BATCH):
        check_exact(f"K1 1080p B={b} -> {dh}x{dw}",
                    resize.resize_nn(frames[:b], dh, dw),
                    pixel.resize_nn(frames[:b], dh, dw), errs)
    for i, (src, dst) in enumerate(ODD_RESIZES):
        f = make_frames(3, *src, seed=10 + i, device=dev)
        check_exact(f"K1 {src} -> {dst}", resize.resize_nn(f, *dst),
                    pixel.resize_nn(f, *dst), errs)
    tables = resize.resize_tables(SRC_H, SRC_W, dh, dw, dev)
    k = cuda_ms(lambda: resize.resize_nn(frames, dh, dw, tables))
    p = cuda_ms(lambda: pixel.resize_nn(frames, dh, dw))
    g = graph_ms(lambda: resize.resize_nn(frames, dh, dw, tables))
    timing(f"K1 1080p B={BATCH} -> {dh}x{dw}", k, p, g)
    return k, p


def plain_cells(frames, ramp, dh, dw, mode):
    return cells.records_for_mode(pixel.resize_nn(frames, dh, dw), mode, ramp)


def phase4_cells(frames: torch.Tensor, errs: list[int]) -> tuple[float, float]:
    say("phase 4: render_cells (K2, K1 for half-block RGB) vs plain, 10 modes")
    ramp = cells.ramp_for_palette(palette.DEFAULT_PALETTE)
    f8 = frames[:8]
    for mode in cells.MODES:
        half = cells.mode_family(mode) in cells.HALFBLOCK_FAMILIES
        for dh in ((2 * TERM_H, 57) if half else (TERM_H, 57)):
            got = cells.render_cells(f8, ramp, dst_h=dh, dst_w=TERM_W, mode=mode)
            check_exact(f"{mode} 1080p B=8 -> {dh}px x {TERM_W}", got,
                        plain_cells(f8, ramp, dh, TERM_W, mode), errs)
        dh = 2 * TERM_H if half else TERM_H
        tables = cells.cell_tables(SRC_H, SRC_W, dh, TERM_W, frames.device)
        k = cuda_ms(lambda: cells.render_cells(f8, ramp, dst_h=dh, dst_w=TERM_W,
                                               mode=mode, tables=tables))
        p = cuda_ms(lambda: plain_cells(f8, ramp, dh, TERM_W, mode))
        timing(f"{mode} 1080p B=8 -> {dh}px x {TERM_W}", k, p)
    plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, FG_TRUECOLOR)
    tables = cells.cell_tables(SRC_H, SRC_W, plan.dst_h_px, plan.dst_w, frames.device)
    args = dict(dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode)
    check_exact(f"{plan.mode} 1080p B={BATCH} (mirror geometry)",
                cells.render_cells(frames, ramp, tables=tables, **args),
                plain_cells(frames, ramp, plan.dst_h_px, plan.dst_w, plan.mode), errs)
    k = cuda_ms(lambda: cells.render_cells(frames, ramp, tables=tables, **args))
    p = cuda_ms(lambda: plain_cells(frames, ramp, plan.dst_h_px, plan.dst_w, plan.mode))
    g = graph_ms(lambda: cells.render_cells(frames, ramp, tables=tables, **args))
    timing(f"K2 {plan.mode} 1080p B={BATCH} -> {plan.dst_h_px}x{plan.dst_w}", k, p, g)
    return k, p


def group_args(grp: server.RenderGroup) -> tuple:
    return (grp.ramp, grp.tint, grp.fg_on_bg, grp.is_rainbow, grp.filter_on)


def phase5_group(dev, stack: torch.Tensor, errs: list[int]) -> tuple[float, float]:
    say("phase 5: K3 render_group vs plain render_compute")
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    result = None
    for caps in (HB_TRUECOLOR, FG_256):
        grp = server.RenderGroup(sizes, TERM_W, TERM_H, caps, SERVER_FILTERS,
                                 device=dev)
        grp.set_filters(SERVER_FILTERS, time_s=1.25)
        m, r = grp.maps, grp.render
        geo = dict(mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)

        def kernel():
            return server.render_group(stack, *group_args(grp), m, **geo)

        def plain():
            return server.render_compute(stack, *group_args(grp), m.cidx, m.src_y,
                                         m.src_x, m.comp_mask, **geo)

        label = (f"K3 {r.mode} {SERVER_SOURCES}x{UPLINK_W}x{UPLINK_H} -> "
                 f"{r.dst_h_px}px x {r.dst_w}, {len(SERVER_FILTERS)} receivers")
        check_exact(label, kernel(), plain(), errs)
        k, p = cuda_ms(kernel), cuda_ms(plain)
        timing(label, k, p, graph_ms(kernel))
        result = result or (k, p)
    return result


def test_pattern_frames(elapsed: float) -> list[np.ndarray]:
    """Every frame the mirror's test-pattern source (640x480) can show in
    its first ``elapsed`` seconds: it moves a colour phase 60 steps/s and a
    bar 160 px/s, so one frame per interval between those steps."""
    src = TestPatternSource()
    steps = sorted({k / 160 for k in range(int(elapsed * 160) + 2)}
                   | {k / 60 for k in range(int(elapsed * 60) + 2)})
    frames = []
    for a, b in zip(steps, steps[1:]):
        if b - a < 1e-4:
            continue
        src._t0 = time.monotonic() - (a + b) / 2  # read() at time (a+b)/2
        frames.append(src.read())
    return frames


def mirror_cli_check(renderer: AsciiRenderer) -> None:
    """Run the mirror CLI's snapshot in a subprocess and hold its frame
    against the oracle. The test pattern depends on when the source was
    opened, so the frame is found among the pattern's possible frames
    (rendered by the port on the card) and that frame's oracle bytes must
    equal the CLI's output."""
    env = dict(os.environ, COLORTERM="truecolor", LANG="C.UTF-8")
    env.pop("NO_COLOR", None)
    cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "mirror",
           "--test-pattern", "--snapshot", "--width", "80", "--height", "24"]
    t0 = time.monotonic()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, timeout=300)
    elapsed = time.monotonic() - t0
    if r.returncode != 0 or not r.stdout.endswith(b"\n"):
        raise RuntimeError(f"mirror CLI exited {r.returncode}:\n"
                           f"{r.stderr.decode(errors='replace')[-3000:]}")
    frame = r.stdout[:-1]  # a non-tty writer ends each frame with a newline
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND,
                                wants_padding=False, utf8_support=True)
    candidates = test_pattern_frames(elapsed)
    for start in range(0, len(candidates), 256):
        chunk = candidates[start:start + 256]
        outs = renderer.convert_batch(np.stack(chunk), 80, 24, caps)
        if frame in outs:
            src = chunk[outs.index(frame)]
            want = oracle.ascii_convert_with_capabilities(src, 80, 24, caps)
            if want != frame:
                raise AssertionError("mirror CLI frame differs from the oracle")
            say(f"  ok  mirror CLI --snapshot 80x24 ({len(frame)} bytes, "
                f"{elapsed:.1f} s): byte-identical to the oracle")
            return
    raise AssertionError(f"mirror CLI frame matches none of the "
                         f"{len(candidates)} test-pattern frames")


def phase6_mirror(dev, frames: torch.Tensor) -> None:
    say(f"phase 6: mirror convert_batch, {BATCH} x 1080p -> {TERM_W}x{TERM_H}")
    renderer = AsciiRenderer(device=dev)
    host = frames[:2].cpu().numpy()
    for caps in (FG_TRUECOLOR, HB_TRUECOLOR):
        outs = renderer.convert_batch(frames, TERM_W, TERM_H, caps)
        if len(outs) != BATCH:
            raise AssertionError(f"{len(outs)} frames for a batch of {BATCH}")
        for i in range(2):
            want = oracle.ascii_convert_with_capabilities(host[i], TERM_W, TERM_H, caps)
            if outs[i] != want:
                raise AssertionError(f"{caps.renderer_key()} frame {i} differs "
                                     "from the oracle")
        say(f"  ok  {caps.renderer_key()}: frames 0-1 byte-identical to the oracle")
        plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, caps)
        dev_ms = cuda_ms(lambda: renderer.cells_for_plan(frames, plan), iters=10)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            renderer.convert_batch(frames, TERM_W, TERM_H, caps)
        wall = (time.perf_counter() - t0) / reps
        say(f"  rate {caps.renderer_key()}: device {BATCH / dev_ms * 1e3:.0f} "
            f"frames/s ({dev_ms:.4f} ms per batch), through D2H + emit "
            f"{BATCH / wall:.0f} frames/s [{CARD}]")
    mirror_cli_check(renderer)


def phase7_server(dev) -> None:
    say(f"phase 7: server RenderGroup.step, {SERVER_TICKS} ticks")
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    plan = server.plan_tick(sizes, TERM_W, TERM_H, HB_TRUECOLOR)
    grp = server.RenderGroup(sizes, TERM_W, TERM_H, HB_TRUECOLOR, SERVER_FILTERS,
                             device=dev)
    rng = np.random.default_rng(7)
    stacks = [rng.integers(0, 256, (SERVER_SOURCES, UPLINK_H, UPLINK_W, 3),
                           dtype=np.uint8) for _ in range(4)]
    stacks_dev = [torch.from_numpy(s).to(dev) for s in stacks]
    composites = [compositor.composite_reference(s, plan.composite) for s in stacks]
    staging = cells.HostStaging()
    expected: dict[tuple, bytes] = {}
    r = grp.render

    def tick(t: int) -> list[bytes]:
        records = grp.step(stacks_dev[t % len(stacks)], time_s=100.0 + t / 60)
        host = cells.records_to_numpy(records, staging)
        return emitter.emit_frames(host, r.mode, grp.palette, pad_w=r.pad_w,
                                   pad_h=r.pad_h)

    for t in range(SERVER_TICKS):
        time_s = 100.0 + t / 60
        outs = tick(t)
        for c, name in enumerate(SERVER_FILTERS):
            tint = filters.rainbow_color(time_s) if name == "rainbow" else None
            key = (t % len(stacks), name, tint)
            if key not in expected:
                filtered = filters.apply_color_filter_reference(
                    composites[key[0]], name, time_s)
                expected[key] = oracle.ascii_convert_with_capabilities(
                    filtered, TERM_W, 2 * TERM_H, HB_TRUECOLOR)
            if outs[c] != expected[key]:
                raise AssertionError(f"tick {t} receiver {c} ({name}) differs "
                                     "from the oracle")
    say(f"  ok  {SERVER_TICKS} ticks x {len(SERVER_FILTERS)} receivers: "
        "byte-identical to the oracle")
    dev_ms = cuda_ms(lambda: grp.step(stacks_dev[0], time_s=100.0), iters=50)
    t0 = time.perf_counter()
    for t in range(SERVER_TICKS):
        tick(t)
    wall = time.perf_counter() - t0
    say(f"  rate server tick: device {dev_ms:.4f} ms per tick, through D2H + emit "
        f"{SERVER_TICKS / wall:.1f} ticks/s [{CARD}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = phase1_device()
    phase2_build()
    frames = make_frames(BATCH, SRC_H, SRC_W, seed=2, device=dev)
    errs: dict[str, list[int]] = {k.name: [] for k in KERNELS}
    times = {
        "resize_nn": phase3_resize(dev, frames, errs["resize_nn"]),
        "cell_records": phase4_cells(frames, errs["cell_records"]),
    }
    stack = make_frames(SERVER_SOURCES, UPLINK_H, UPLINK_W, seed=5, device=dev)
    times["render_group"] = phase5_group(dev, stack, errs["render_group"])

    for k in KERNELS:
        k.launches = 0
    phase6_mirror(dev, frames)
    phase7_server(dev)
    launches = {k.name: k.launches for k in KERNELS}
    say(f"phase 8: launches over phases 6-7: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    report = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": max(errs[k.name]), "ms": times[k.name][0],
         "plain_ms": times[k.name][1]}
        for k in KERNELS]}
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
