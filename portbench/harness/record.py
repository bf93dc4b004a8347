"""What a run hands to the metric readers, and the statistics they share."""

from __future__ import annotations

import dataclasses
import math

from harness.check import Verdict
from harness.spec import Cell
from harness.tracing import Trace
from harness.window import Window


@dataclasses.dataclass
class Run:
    cell: Cell
    setup_s: float  # process start to the first timed call
    window: Window
    verdict: Verdict
    records_bytes: int  # least bytes one call's records need (harness/yardstick.py)
    trace: Trace | None  # the profile and the traced run's spans; None unprofiled

    def call_ms(self) -> list[float]:
        return [(end - start) / 1e6 for start, end in self.window.calls]

    def span_ms(self, name: str) -> float | None:
        """Mean host ms a call spent in the wrapped call ``name``; None untraced."""
        if self.trace is None or not self.window.calls:
            return None
        total = sum(end - start for n, start, end in self.trace.spans if n == name)
        return total / 1e6 / len(self.window.calls)


def p95(values: list[float]) -> float | None:
    """The 95th percentile by nearest rank: a value that was measured."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]
