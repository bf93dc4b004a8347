"""Latest-frame double buffer + bounded frame queues.

Python equivalents of the reference's lock-free producer/consumer machinery:
- video_frame double buffer (begin_write/commit/latest,
  lib/video/rgba/video_frame.c:214-264): the consumer always sees the most
  recent complete frame; stale frames are dropped, never queued.
- bounded drop-on-full frame queue (src/common/session/pipeline.c:72-80):
  overload shedding keeps latency flat when the consumer falls behind.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any


class LatestFrame:
    """Single-producer latest-value swap with stats (video_frame.c)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._frame: Any = None
        self._seq = 0
        self._ts = 0.0
        self.writes = 0
        self.reads = 0

    def commit(self, frame: Any) -> None:
        with self._lock:
            self._frame = frame
            self._seq += 1
            self._ts = time.monotonic()
            self.writes += 1

    def latest(self) -> tuple[Any, int, float]:
        """-> (frame_or_None, sequence, monotonic commit time) — the commit
        timestamp feeds the server's capture->emit latency tracking."""
        with self._lock:
            self.reads += 1
            return self._frame, self._seq, self._ts


class FrameQueue:
    """Bounded queue that drops the OLDEST entry when full (pipeline.c:72)."""

    def __init__(self, maxsize: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.dropped = 0

    def push(self, item: Any) -> None:
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass

    def pop(self, timeout: float | None = None) -> Any:
        return self._q.get(timeout=timeout)

    def pop_nowait(self) -> Any | None:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None
