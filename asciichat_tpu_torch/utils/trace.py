"""Tracing: spans and counters of the program's stages, and latency histograms.

A span times one stage of a request (``with trace.span("render.emit"):``,
or ``@trace.spanned(...)`` on a function); a counter counts the work done
inside it (``trace.count("ansi_bytes", n)`` adds to the innermost open span).
The enclosing span is found through a context variable, so nesting needs no
arguments. Parity with lib/util/time.c's START_TIMER / STOP_TIMER and the
ASCII_BREAKDOWN line of the C renderer (lib/video/ascii/ascii.c:268-382).

- **Aggregates, always on.** Every span name and counter of a
  :class:`Tracer` has a count, a total and a whole-run log-bucketed
  histogram. The render path and the kernel build use the process's tracer
  (:data:`PROCESS`); the server's ticks use their own (``tick``, ``audio``),
  which the inspector reads.
- **Records, while torch.profiler records.** While a ``torch.profiler``
  session is recording, each span also keeps a :class:`SpanRecord` (its
  name, start and end in ``time.perf_counter_ns``, its parent span, the
  request it serves and its counts) and opens a
  ``record_function("asciichat.<name>")`` range, so the program's stages lie
  on the profiler trace's own timeline. :func:`records` returns the records
  kept since the profiler began recording; a record's clock is the host's,
  the range's the trace's. With no profiler recording, no record is kept
  and no range is opened.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import math
import sys
import threading
import time
from typing import NamedTuple

# Histogram buckets grow by this ratio: a bucket's geometric middle lies
# within 1% of every value in the bucket.
BUCKET_RATIO = 1.02
_LOG_RATIO = math.log(BUCKET_RATIO)
RANGE_PREFIX = "asciichat."

_clock = time.perf_counter_ns


def pretty_duration(seconds: float) -> str:
    if seconds < 1e-6:
        return f"{seconds * 1e9:.0f}ns"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.1f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds:.2f}s"


class Histogram:
    """Count, total, largest value and a log-bucketed histogram of values
    (not thread-safe: its owner locks). Values under ``unit`` share the
    first bucket; above it each percentile is within 1% of a value added."""

    __slots__ = ("unit", "count", "total", "worst", "buckets")

    def __init__(self, unit: float = 1.0):
        self.unit = unit
        self.count = 0
        self.total = 0
        self.worst = 0
        self.buckets: dict[int, int] = {}

    def add(self, value) -> None:
        self.count += 1
        self.total += value
        if value > self.worst:
            self.worst = value
        units = value / self.unit
        i = int(math.log(units) / _LOG_RATIO) if units >= 1.0 else 0
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """The nearest-rank ``q``-th percentile (q in [0, 100]): the middle
        of the bucket that holds it, never above the largest value."""
        if not self.count:
            return 0.0
        rank = min(self.count - 1, int(q / 100.0 * self.count))
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen > rank:
                return min(self.worst, BUCKET_RATIO ** (i + 0.5) * self.unit)
        return self.worst


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    id: int
    parent: int | None  # the enclosing span's id
    request: int  # shared by the spans of one request
    counts: dict[str, int]


class _Capture:
    """The records of the profiler session that is recording, or of the
    last one: cleared when a span first finds a new session recording."""

    def __init__(self):
        self.lock = threading.Lock()
        self.open = False
        self.records: list[SpanRecord] = []

    def begin(self) -> None:
        with self.lock:
            if not self.open:
                self.records = []
                self.open = True


_CAPTURE = _Capture()
_CURRENT: contextvars.ContextVar[_Span | None] = contextvars.ContextVar(
    "asciichat_span", default=None)
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)


def _recording_profiler():
    """torch's autograd profiler module while a profiler session records,
    else None (and None where torch was never imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return prof
    return None


class _Span:
    __slots__ = ("tracer", "label", "name", "new_request", "start", "id",
                 "parent", "request", "counts", "range", "token")

    def __init__(self, tracer: Tracer, label: str, new_request: bool):
        self.tracer = tracer
        self.label = label
        self.name = tracer.prefix + label
        self.new_request = new_request

    def __enter__(self) -> _Span:
        parent = _CURRENT.get()
        self.parent = parent.id if parent is not None else None
        self.request = (next(_REQUEST_IDS) if self.new_request or parent is None
                        else parent.request)
        self.id = next(_SPAN_IDS)
        self.token = _CURRENT.set(self)
        prof = _recording_profiler()
        if prof is None:
            if _CAPTURE.open:
                _CAPTURE.open = False
            self.range = self.counts = None
            self.start = _clock()
            return self
        if not _CAPTURE.open:
            _CAPTURE.begin()
        self.counts = {}
        self.range = prof.record_function(RANGE_PREFIX + self.name)
        self.start = _clock()
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
        end = _clock()
        _CURRENT.reset(self.token)
        self.tracer._add_span(self.label, end - self.start)
        if self.range is not None:
            _CAPTURE.records.append(SpanRecord(self.name, self.start, end, self.id,
                                               self.parent, self.request, self.counts))

    def add(self, key: str, n: int = 1) -> None:
        """Count ``n`` of ``key`` on this span: its tracer's counter
        ``<label>.<key>`` and, while recorded, the record's counts."""
        self.tracer.count(f"{self.label}.{key}", n)
        if self.counts is not None:
            self.counts[key] = self.counts.get(key, 0) + n


class Tracer:
    """Named spans and counters with whole-run aggregates (thread-safe).

    A span's record and profiler range carry the tracer's name as a prefix
    (``tick.fill``); the aggregates are kept by the span's own label."""

    def __init__(self, name: str = ""):
        self.name = name
        self.prefix = f"{name}." if name else ""
        self._lock = threading.Lock()
        self._spans: dict[str, Histogram] = {}  # ns
        self._counters: dict[str, Histogram] = {}

    def span(self, label: str, request: bool = False) -> _Span:
        """A context manager timing ``label``; ``request`` starts a new
        request (else the enclosing span's, or a new one at the top)."""
        return _Span(self, label, request)

    def _add_span(self, label: str, ns: int) -> None:
        with self._lock:
            hist = self._spans.get(label)
            if hist is None:
                hist = self._spans[label] = Histogram()
            hist.add(ns)

    def add(self, label: str, seconds: float) -> None:
        """A stage timed elsewhere, e.g. on the device by a CUDA event pair."""
        self._add_span(label, int(seconds * 1e9))

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            hist = self._counters.get(key)
            if hist is None:
                hist = self._counters[key] = Histogram()
            hist.add(n)

    def snapshot(self) -> dict[str, tuple[float, int]]:
        """label -> (total seconds, count) of every span."""
        with self._lock:
            return {k: (h.total / 1e9, h.count) for k, h in self._spans.items()}

    def counters(self) -> dict[str, int]:
        """key -> total of every counter."""
        with self._lock:
            return {k: h.total for k, h in self._counters.items()}

    def reset(self) -> None:
        """Drop the aggregates (e.g. the warm-up ticks before a soak's
        steady window: one slow first tick otherwise weighs on every mean)."""
        with self._lock:
            self._spans.clear()
            self._counters.clear()

    def breakdown(self) -> str | None:
        """"TICK_BREAKDOWN: a=1.2ms, b=300us (total=1.5ms)": each span's
        mean, as the server's SLOW_TICK warning prints it."""
        snap = self.snapshot()
        if not snap:
            return None
        parts = []
        total = 0.0
        for label, (t, n) in snap.items():
            avg = t / max(n, 1)
            parts.append(f"{label}={pretty_duration(avg)}")
            total += avg
        return (f"{(self.name or 'trace').upper()}_BREAKDOWN: {', '.join(parts)} "
                f"(total={pretty_duration(total)})")


PROCESS = Tracer()


def span(name: str, request: bool = False) -> _Span:
    """A span of the process's tracer."""
    return PROCESS.span(name, request)


def spanned(name: str, request: bool = False):
    """Decorator: each call of the function is a span of the process's tracer."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _Span(PROCESS, name, request):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(key: str, n: int = 1) -> None:
    """Count ``n`` of ``key`` on the innermost open span, or on the
    process's tracer where no span is open."""
    current = _CURRENT.get()
    if current is not None:
        current.add(key, n)
    else:
        PROCESS.count(key, n)


def records() -> list[SpanRecord]:
    """The span records kept since torch.profiler last began recording."""
    return list(_CAPTURE.records)


class LatencyTracker:
    """Whole-run latency percentiles (thread-safe).

    The deadline observability the reference gets from its per-stage
    ASCII_BREAKDOWN timers (lib/video/ascii/ascii.c:268-382), the >5 ms
    SLOW_ASCII_CONVERT warning (src/server/stream.c:846-850), and the
    16.67 ms tick deadline (src/server/render.c:4-7): callers `add()` each
    tick's latency and export `stats_ms()` (p50/p90/p99/worst) through the
    server stats line, the inspector, and the soak artifacts. Samples go
    into the spans' histogram buckets, so a percentile covers every sample
    since the last reset, within 1%.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._hist = Histogram(unit=1e-9)

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def worst(self) -> float:
        return self._hist.worst

    def add(self, seconds: float) -> None:
        with self._lock:
            self._hist.add(seconds)

    def reset(self) -> None:
        """Drop accumulated samples (e.g. warm-up ticks before a
        steady-state soak window)."""
        with self._lock:
            self._hist = Histogram(unit=1e-9)

    def percentile(self, *qs: float) -> list[float]:
        """Nearest-rank percentiles in seconds (qs in [0,100])."""
        with self._lock:
            return [float(self._hist.percentile(q)) for q in qs]

    def stats_ms(self) -> dict:
        p50, p90, p99 = self.percentile(50, 90, 99)
        return {
            "n": self.count,
            "p50_ms": round(p50 * 1e3, 3),
            "p90_ms": round(p90 * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "worst_ms": round(self.worst * 1e3, 3),
        }
