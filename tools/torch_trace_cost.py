"""The cost of the port's tracer (asciichat_tpu_torch/utils/trace.py).

    python3 tools/torch_trace_cost.py

Prints one JSON line: the ns a span costs with no profiler recording (its
aggregates only), with a count added, and under torch.profiler (a record
and a ``record_function`` range besides, the CPU activity and, on a CUDA
machine, the CUDA activity on), beside the ns of two ``perf_counter_ns``
reads and of one ``record_function`` entered with no profiler. Host-clock
numbers: they hold for the machine that printed them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from asciichat_tpu_torch.utils import trace  # noqa: E402

OFF_N = 200_000
ON_N = 20_000


def ns_each(fn, n: int) -> float:
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def span() -> None:
    with trace.span("cost.span"):
        pass


def span_counted() -> None:
    with trace.span("cost.span") as sp:
        sp.add("bytes", 1)


def clock_pair() -> None:
    time.perf_counter_ns()
    time.perf_counter_ns()


def bare_range() -> None:
    with torch.profiler.record_function("cost.range"):
        pass


def card() -> str | None:
    if not torch.cuda.is_available():
        return None
    try:
        query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        return subprocess.run(query, capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main() -> int:
    out = {"cpu_count": os.cpu_count(), "card": card(), "torch": torch.__version__,
           "clock_pair_ns": ns_each(clock_pair, OFF_N),
           "record_function_off_ns": ns_each(bare_range, ON_N),
           "span_off_ns": ns_each(span, OFF_N),
           "span_counted_off_ns": ns_each(span_counted, OFF_N)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["span_on_ns"] = ns_each(span, ON_N)
        out["span_counted_on_ns"] = ns_each(span_counted, ON_N)
    out["records"] = len(trace.records())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
