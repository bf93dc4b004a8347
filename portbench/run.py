"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and its
metrics are found by name from BENCHMARK.json (harness/spec.py). The run:

1. needs as many CUDA cards as the cell asks for, else it exits 2 and prints
   no result;
2. set-up: sets the process as the configuration states it
   (harness/process.py), loads asciichat_tpu_torch from this checkout (its
   kernels build into the checkout's build/ on the first run), makes the
   frame pool on the card from the seed and pins it in host memory, and makes
   the traffic's warm-up calls;
3. the window: one caller converts the pool's batches in a closed loop
   through ``AsciiRenderer.convert_batch`` for ``--seconds``; with
   ``--trace 1`` under the benchmark's spans and torch.profiler;
4. reads the card's peak memory, frees the program's state, converts every
   pool frame with the plain reference (reference/) and judges the returned
   frames (harness/check.py);
5. prints the compared numbers with their limits as the last lines of
   standard error, and one JSON line as the last line of standard output.

It exits 3, with no result, if a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from harness import check, frames, guard, process, spec, tracing, window, yardstick  # noqa: E402
from harness.record import Run  # noqa: E402
from reference.render import Reference  # noqa: E402


class NoCard(RuntimeError):
    pass


def find_devices(chips: int) -> torch.device:
    """The card the run uses; raises NoCard where PyTorch sees fewer cards
    than the cell asks for. There is no CPU fallback."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", torch.cuda.current_device())


def load_program():
    """asciichat_tpu_torch from this checkout, and nowhere else."""
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))
    import asciichat_tpu_torch
    from asciichat_tpu_torch.render import pipeline, types
    origin = Path(asciichat_tpu_torch.__file__).absolute()
    if ROOT not in origin.parents:
        raise ImportError(f"asciichat_tpu_torch comes from {origin}, not from {ROOT}")
    return pipeline, types


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "device: cpu"
    try:
        query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        smi = subprocess.run(query, capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: {smi}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def jax_loaded() -> bool:
    """Whether a module of JAX or of the JAX package is loaded; says which."""
    loaded = guard.forbidden_loaded()
    if loaded:
        say(f"portbench: loaded in this process: {', '.join(loaded)}")
    return bool(loaded)


def main(argv=None) -> int:
    args = parse(argv)
    traced = bool(args.trace)
    cell = spec.load_cell(ROOT, args.workload, traced)
    try:
        device = find_devices(cell.chips)
    except NoCard as e:
        say(f"portbench: {e}")
        return 2
    conf, traffic = cell.config, cell.traffic
    for line in process.apply(conf):
        say(f"portbench: set-up: {line}")
    pipeline, types = load_program()
    say(f"portbench: set-up: imports and card {time.perf_counter() - START:.3f} s")

    # set-up
    pool = frames.make_pool(traffic, args.seed, device)
    say(f"portbench: set-up: frame pool made and pinned {time.perf_counter() - START:.3f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    b = traffic["batch"]
    batches = [pool[i * b:(i + 1) * b] for i in range(traffic["pool_batches"])]
    renderer = pipeline.AsciiRenderer(palette=conf["palette"], device=device)
    caps = types.TerminalCapabilities(types.ColorLevel[conf["color_level"]],
                                      types.RenderMode[conf["render_mode"]],
                                      wants_padding=conf["padding"])
    if caps.renderer_key() != conf["mode"]:
        raise ValueError(f"capabilities select {caps.renderer_key()}, the configuration "
                         f"states {conf['mode']}")

    def convert(batch):
        return renderer.convert_batch(batch, conf["width"], conf["height"], caps,
                                      use_aspect_ratio=conf["keep_aspect"])

    longest = 0
    for i in range(traffic["warmup_calls"]):
        longest = max([longest, *map(len, convert(batches[i % len(batches)]))])
        if i == 0:
            say(f"portbench: set-up: first call {time.perf_counter() - START:.3f} s")
    per_call = traffic["sample_frames_per_call"]
    store = window.SampleStore(traffic["sample_calls"] * per_call, longest * 5 // 4)
    spans = tracing.Spans()
    run_args = (convert, batches, args.seconds, args.seed, store, per_call)
    setup_s = time.perf_counter() - START

    # the window
    trace = None
    if traced:
        with tracing.installed(renderer, spans), tracing.Profile(device) as prof:
            win = window.run(*run_args, call_scope=spans.call_scope)
    else:
        win = window.run(*run_args)
    if jax_loaded():
        return 3
    if traced:
        trace = tracing.read_profile(prof.events(), spans.events)
        del prof
        kernels = [op for op in trace.ops if op.kind == "kernel"]
        say(f"portbench: trace: {len(trace.ops)} device operations, {len(kernels)} kernels, "
            f"{sum(op.span is not None for op in kernels)} of them tied to their launch")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(card_line(device))
    del renderer, convert, run_args
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference and the check
    t = time.perf_counter()
    ref = Reference(conf, traffic["source_h"], traffic["source_w"])
    host = pool.numpy()
    expected = [ref.frame(host[i]) for i in range(host.shape[0])]
    verdict = check.judge(win, expected)
    say(f"portbench: reference {time.perf_counter() - t:.3f} s for {len(expected)} frames; "
        f"{len(win.calls)} calls, {win.frames_returned} frames in {win.seconds:.6f} s; "
        f"{verdict.sampled} frames compared byte for byte")

    run = Run(cell, setup_s, win, verdict, yardstick.records_bytes(ref, b), trace)
    metrics = {}
    for m in cell.metrics:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        fps = (verdict.attempted - verdict.failed) / win.seconds
        say(f"portbench: traced window {fps:.4f} frames/s (under the spans and the profiler)")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["checks"] = verdict.checks

    if jax_loaded():
        return 3
    for name, c in verdict.checks.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
