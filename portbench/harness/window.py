"""The timed window: one caller, a closed loop of batch conversions.

Each call takes the next batch of the pool (cycled) and waits for its frames
before the next call starts; the caller drops a call's frames once it has
looked at them, as a converter that writes them out would. The window runs
calls until ``seconds`` have passed since the first started; it is the time
from the first call's start to the last call's end, so every frame returned
counts over all the time taken. Of every call it keeps the wall time, the
batch and each frame's length; of a reservoir of calls drawn from the seed
(uniform over the window's calls, whatever their number) it copies a few
whole frames at positions drawn from the seed into a buffer filled before
the window, for the comparison after it.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections.abc import Callable, Sequence
from contextlib import AbstractContextManager, nullcontext

import numpy as np


class SampleStore:
    """Copies of sampled frames in rows of one buffer, its pages touched when
    it is made, so that keeping a sample allocates nothing in the window."""

    def __init__(self, rows: int, width: int):
        self.buf = np.empty((rows, width), np.uint8)
        self.buf.fill(0)
        self.lengths = np.zeros(rows, np.int64)
        self.longer: dict[int, bytes] = {}  # frames wider than a row, whole

    def put(self, row: int, frame: bytes) -> None:
        n = len(frame)
        self.lengths[row] = n
        self.longer.pop(row, None)
        if n <= self.buf.shape[1]:
            self.buf[row, :n] = np.frombuffer(frame, np.uint8)
        else:
            self.longer[row] = bytes(frame)

    def get(self, row: int) -> bytes:
        return self.longer.get(row) or self.buf[row, :self.lengths[row]].tobytes()


@dataclasses.dataclass
class Sample:
    call: int
    batch: int
    positions: list[int]  # in the batch
    rows: list[int]  # of the store, one a position


@dataclasses.dataclass
class Window:
    batch_size: int
    calls: list[tuple[int, int]]  # (start, end) of each call, perf_counter_ns
    batches: list[int]  # the pool batch each call converted
    lengths: list[np.ndarray]  # each call's frame lengths, in the order returned
    samples: list[Sample]
    store: SampleStore

    @property
    def seconds(self) -> float:
        return (self.calls[-1][1] - self.calls[0][0]) / 1e9 if self.calls else 0.0

    @property
    def frames_returned(self) -> int:
        return sum(len(n) for n in self.lengths)


def run(convert: Callable[[object], Sequence[bytes]], batches: Sequence[object],
        seconds: float, seed: int, store: SampleStore, sample_frames: int, batch_size: int,
        call_scope: Callable[[], AbstractContextManager] = nullcontext) -> Window:
    """Convert ``batches`` in turn for ``seconds``, sampling ``sample_frames``
    frames of each call in the reservoir, which has as many calls as
    ``store`` has rows for; ``batch_size`` is the frames a call is due to
    return; ``call_scope`` wraps each call (the traced run names it for the
    profiler)."""
    rng = random.Random(f"portbench-sample-{seed}")
    sample_calls = store.buf.shape[0] // sample_frames
    win = Window(batch_size, [], [], [], [], store)
    clock = time.perf_counter_ns
    stop = None
    n = 0
    while True:
        b = n % len(batches)
        start = clock()
        with call_scope():
            frames = convert(batches[b])
        end = clock()
        if stop is None:
            stop = start + int(seconds * 1e9)
        win.calls.append((start, end))
        win.batches.append(b)
        win.lengths.append(np.fromiter(map(len, frames), np.int64, len(frames)))
        slot = n if n < sample_calls else rng.randrange(n + 1)
        if slot < sample_calls:
            picked = rng.sample(range(len(frames)), min(sample_frames, len(frames)))
            rows = [slot * sample_frames + j for j in range(len(picked))]
            for p, row in zip(picked, rows):
                store.put(row, frames[p])
            sample = Sample(n, b, picked, rows)
            if slot < len(win.samples):
                win.samples[slot] = sample
            else:
                win.samples.append(sample)
        del frames
        n += 1
        if end >= stop:
            return win
