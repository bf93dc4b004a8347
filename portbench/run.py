"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and its
metrics are found by name from BENCHMARK.json (harness/spec.py), and so is
the path its cells drive: ``paths/<path>.py`` of the configuration's
``path``, ``paths/convert_batch.py`` where it names none. The run:

1. needs as many CUDA cards as the cell asks for, else it exits 2 and prints
   no result;
2. set-up: sets the process as the configuration states it
   (harness/process.py), then the path's ``Bench(cell, seed, device, mark)``
   loads asciichat_tpu_torch from this checkout (its kernels build into the
   checkout's build/ on the first run), makes the traffic's inputs from the
   seed and makes its warm-up calls;
3. the window (harness/window.py): one caller makes the path's timed call
   (``Bench.call``) on ``Bench.states`` in turn, in a closed loop, for
   ``--seconds``; with ``--trace 1`` under the path's wrappers
   (``Bench.installed``, harness/tracing.Spans named by the path's ``CALL``)
   and torch.profiler; with ``--trace 0`` under torch.profiler alone where
   the cell reports an end-to-end metric of the device trace;
4. reads the card's peak memory, drops the program's state
   (``Bench.release``) and has the path judge what the window returned
   against its plain reference (``Bench.judge``: the verdict and the
   yardstick's least bytes a call);
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

from harness import guard, process, spec, tracing, window  # noqa: E402
from harness.record import Run  # noqa: E402


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
    conf = cell.config
    for line in process.apply(conf):
        say(f"portbench: set-up: {line}")
    path = spec.path(conf)

    def mark(what: str) -> None:
        say(f"portbench: set-up: {what} {time.perf_counter() - START:.3f} s")

    # set-up
    bench = path.Bench(cell, args.seed, device, mark)
    spans = tracing.Spans(path.CALL)
    run_args = (bench.call, bench.states, args.seconds, args.seed, bench.store, bench.per_call,
                bench.batch_size)
    setup_s = time.perf_counter() - START

    # the window; an untraced run whose cell reports an end-to-end metric of
    # the device trace profiles it too, without the path's wrappers
    profiled = traced or any(m["source"] == "device_trace" for m in cell.metrics)
    trace = None
    if traced:
        with bench.installed(spans), tracing.Profile(device) as prof:
            win = window.run(*run_args, call_scope=spans.call_scope)
    elif profiled:
        with tracing.Profile(device) as prof:
            win = window.run(*run_args, call_scope=spans.call_scope)
    else:
        win = window.run(*run_args)
    if jax_loaded():
        return 3
    if profiled:
        trace = tracing.read_profile(prof.events(), spans.events, path.CALL)
        del prof
        kernels = [op for op in trace.ops if op.kind == "kernel"]
        say(f"portbench: trace: {len(trace.ops)} device operations, {len(kernels)} kernels, "
            f"{sum(op.span is not None for op in kernels)} of them tied to their launch")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(card_line(device))
    bench.release()
    del run_args
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference and the check
    verdict, least_bytes = bench.judge(win, say)
    run = Run(cell, setup_s, win, verdict, least_bytes, trace)
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
    if traced:
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
