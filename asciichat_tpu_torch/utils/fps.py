"""FPS counter: rolling 30-frame window (lib/ui/fps_counter.c:15,74-97).

Reference semantics, re-derived: a circular buffer of the last
FPS_WINDOW_SIZE=30 tick timestamps; the rate is (count-1) intervals over the
oldest->newest elapsed time, 0.0 until two ticks exist. (An earlier EMA
implementation cited the same file while behaving differently — converging
~50% slower on rate steps — which misled parity work.)
"""

from __future__ import annotations

import collections
import time

FPS_WINDOW_SIZE = 30  # fps_counter.c:15


class FpsCounter:
    def __init__(self, window: int = FPS_WINDOW_SIZE):
        self._times: collections.deque[float] = collections.deque(maxlen=window)
        self.fps = 0.0
        self.frames = 0

    def tick(self, now: float | None = None) -> float:
        self._times.append(time.monotonic() if now is None else now)
        self.frames += 1
        n = len(self._times)
        if n < 2:
            self.fps = 0.0
            return self.fps
        elapsed = self._times[-1] - self._times[0]
        self.fps = (n - 1) / elapsed if elapsed > 0 else 0.0
        return self.fps
