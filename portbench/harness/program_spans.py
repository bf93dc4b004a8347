"""The program's own span records, read in the traced window and mapped onto
the device trace's clock.

asciichat_tpu_torch keeps a record of each of its spans while torch.profiler
records (``asciichat_tpu_torch/utils/trace.py``: name, start and end in
``time.perf_counter_ns``, parent, request, counts), and aggregates of every
span name for the whole process. A program that keeps no such records gives
every reader here nothing, and the metric is left out of the result line.

The records' clock is the window's (``perf_counter_ns``); the profile's is
the trace's, in microseconds. The benchmark's own spans (``Trace.spans``)
were taken on the first clock around the profiler ranges of the same names
(``Trace.inner``), so the offset between the two clocks is the median, over
those pairs matched by name and order, of the range's start less the span's.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
from collections import defaultdict

MODULE = "asciichat_tpu_torch.utils.trace"
_FITS: dict[int, ClockFit | None] = {}


def program_trace():
    """The program's tracing module where it keeps span records, else None."""
    mod = sys.modules.get(MODULE)
    if mod is None or not hasattr(mod, "records") or not hasattr(mod, "PROCESS"):
        return None
    return mod


def window_records(run, name: str) -> list | None:
    """The program's records named ``name`` that start inside the traced
    window; None untraced or where the program keeps no records."""
    mod = program_trace()
    if mod is None or run.trace is None or not run.window.calls:
        return None
    lo, hi = run.window.calls[0][0], run.window.calls[-1][1]
    return [r for r in mod.records() if r.name == name and lo <= r.start_ns <= hi]


def per_call_ms(run, name: str) -> float | None:
    """Mean ms a window's call spends in the program's span ``name``."""
    recs = window_records(run, name)
    if not recs:
        return None
    return sum(r.end_ns - r.start_ns for r in recs) / 1e6 / len(run.window.calls)


@dataclasses.dataclass
class ClockFit:
    offset_us: float  # trace clock (us) = perf_counter_ns / 1e3 + offset_us
    spread_us: float  # interquartile range of the pairs' offsets
    worst_us: float  # the farthest pair from the offset
    pairs: int


def clock_fit(run) -> ClockFit | None:
    """The offset from ``perf_counter_ns`` to the trace's clock, fitted on
    the benchmark's spans and their profiler ranges; None untraced. Said
    once a run on standard error."""
    if run.trace is None:
        return None
    key = id(run.trace)
    if key not in _FITS:
        _FITS[key] = _fit(run.trace)
        fit = _FITS[key]
        if fit is not None:
            print(f"portbench: program spans: clock offset {fit.offset_us:.3f} us, spread "
                  f"(IQR) {fit.spread_us:.3f} us, farthest pair {fit.worst_us:.3f} us, "
                  f"{fit.pairs} pairs", file=sys.stderr, flush=True)
    return _FITS[key]


def _fit(trace) -> ClockFit | None:
    host: dict[str, list[int]] = defaultdict(list)
    for name, start, _ in trace.spans:
        host[name].append(start)
    ranges: dict[str, list[float]] = defaultdict(list)
    for name, start, _ in trace.inner.items:
        ranges[name].append(start)
    offsets = []
    for name, starts in host.items():
        if len(starts) == len(ranges[name]):
            offsets += [ts - ns / 1e3 for ns, ts in zip(sorted(starts), sorted(ranges[name]))]
    if not offsets:
        return None
    offset = statistics.median(offsets)
    q1, _, q3 = statistics.quantiles(offsets, n=4) if len(offsets) > 1 else (offset,) * 3
    return ClockFit(offset, q3 - q1, max(abs(o - offset) for o in offsets), len(offsets))


def on_trace_clock(run, name: str) -> list[tuple[float, float]] | None:
    """The window's spans ``name`` as (start, end) on the trace's clock (us),
    in order; None where there are none or no fit."""
    recs = window_records(run, name)
    fit = clock_fit(run)
    if not recs or fit is None:
        return None
    return sorted((r.start_ns / 1e3 + fit.offset_us, r.end_ns / 1e3 + fit.offset_us)
                  for r in recs)


def idle_intervals(trace) -> list[tuple[float, float]]:
    """The window's stretches with no device operation (us, in order)."""
    out, edge = [], trace.window[0]
    for a, b in [*trace.busy_intervals(), (trace.window[1], trace.window[1])]:
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    return out


def overlap_us(xs: list[tuple[float, float]], ys: list[tuple[float, float]]) -> float:
    """The time two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
