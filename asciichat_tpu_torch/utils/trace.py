"""Tracing / profiling: named timers with rate-limited breakdown logging.

Parity with lib/util/time.c's START_TIMER / STOP_TIMER_AND_LOG_EVERY macros
and the ASCII_BREAKDOWN line the render path emits (lib/video/ascii/
ascii.c:268-382): sections accumulate wall time; `breakdown()` prints an
"alloc=.., resize=.., print=.., pad=.." style summary, rate-limited.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

from asciichat_tpu_torch.utils.logsys import RateLimited, get_logger

log = get_logger("trace")


def pretty_duration(seconds: float) -> str:
    if seconds < 1e-6:
        return f"{seconds * 1e9:.0f}ns"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.1f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds:.2f}s"


class Tracer:
    """Named section timers (thread-safe)."""

    def __init__(self, name: str = "trace", log_every_s: float = 3.0):
        self.name = name
        self._lock = threading.Lock()
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._rate = RateLimited(log_every_s)

    @contextlib.contextmanager
    def section(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._totals[label] = self._totals.get(label, 0.0) + dt
                self._counts[label] = self._counts.get(label, 0) + 1

    def snapshot(self) -> dict[str, tuple[float, int]]:
        with self._lock:
            return {k: (self._totals[k], self._counts[k]) for k in self._totals}

    def reset(self) -> None:
        """Drop accumulated section totals (e.g. jit-warmup ticks before a
        steady-state soak window — one compile-spiked 'convert' section
        otherwise inflates the reported stage averages forever)."""
        with self._lock:
            self._totals.clear()
            self._counts.clear()

    def breakdown(self, reset: bool = True, force: bool = False) -> str | None:
        """Rate-limited "BREAKDOWN: a=1.2ms, b=300us (total=1.5ms)" log line."""
        if not force and not self._rate.should_log(self.name):
            return None
        snap = self.snapshot()
        if not snap:
            return None
        parts = []
        total = 0.0
        for label, (t, n) in snap.items():
            avg = t / max(n, 1)
            parts.append(f"{label}={pretty_duration(avg)}")
            total += avg
        line = f"{self.name.upper()}_BREAKDOWN: {', '.join(parts)} (total={pretty_duration(total)})"
        log.debug(line)
        if reset:
            with self._lock:
                self._totals.clear()
                self._counts.clear()
        return line


class LatencyTracker:
    """Fixed-window latency percentile tracker (thread-safe).

    The deadline observability the reference gets from its per-stage
    ASCII_BREAKDOWN timers (lib/video/ascii/ascii.c:268-382), the >5 ms
    SLOW_ASCII_CONVERT warning (src/server/stream.c:846-850), and the
    16.67 ms tick deadline (src/server/render.c:4-7): callers `add()` each
    tick's latency and export `stats_ms()` (p50/p90/p99/worst) through the
    server stats line, the inspector, and the soak artifacts.
    """

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._samples: collections.deque[float] = collections.deque(maxlen=window)
        self.count = 0
        self.worst = 0.0

    def add(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1
            if seconds > self.worst:
                self.worst = seconds

    def reset(self) -> None:
        """Drop accumulated samples (e.g. jit-warmup ticks before a
        steady-state soak window)."""
        with self._lock:
            self._samples.clear()
            self.count = 0
            self.worst = 0.0

    def percentile(self, *qs: float) -> list[float]:
        """Nearest-rank percentiles over the current window (qs in [0,100])."""
        with self._lock:
            if not self._samples:
                return [0.0] * len(qs)
            s = sorted(self._samples)
        return [s[min(len(s) - 1, int(q / 100.0 * len(s)))] for q in qs]

    def stats_ms(self) -> dict:
        p50, p90, p99 = self.percentile(50, 90, 99)
        return {
            "n": self.count,
            "p50_ms": round(p50 * 1e3, 3),
            "p90_ms": round(p90 * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "worst_ms": round(self.worst * 1e3, 3),
        }
