"""Whether the frames the window returned are the reference's.

After the window the reference converts every frame of the pool. Every call's
frames are then held to it by count (the batch's size) and by length, and
the sampled frames byte for byte. Each number compared has the limit 0: the configuration
promises byte-identical frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness.window import Window


@dataclasses.dataclass
class Verdict:
    checks: dict[str, dict]  # name -> {"value": n, "limit": 0}
    attempted: int
    failed: int
    sampled: int

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and all(c["value"] <= c["limit"] for c in self.checks.values())


def judge(win: Window, expected: list[bytes]) -> Verdict:
    """``expected[i]``: the reference's frame of pool frame ``i``."""
    b = win.batch_size
    want = np.array([len(f) for f in expected], dtype=np.int64)
    count_off = 0
    bad: set[tuple[int, int]] = set()
    for call, (batch, lengths) in enumerate(zip(win.batches, win.lengths)):
        count_off += abs(b - len(lengths))
        got = lengths[:b]
        wrong = np.flatnonzero(got != want[batch * b: batch * b + len(got)])
        bad.update((call, int(p)) for p in wrong)
    wrong_length = len(bad)
    sampled = wrong_bytes = 0
    for s in win.samples:
        for pos, row in zip(s.positions, s.rows):
            sampled += 1
            if pos >= b or win.store.get(row) != expected[s.batch * b + pos]:
                wrong_bytes += 1
                bad.add((s.call, pos))
    checks = {
        "frames_count_off": {"value": count_off, "limit": 0},
        "frames_wrong_length": {"value": wrong_length, "limit": 0},
        "sampled_frames_wrong": {"value": wrong_bytes, "limit": 0},
    }
    return Verdict(checks, len(win.calls) * b, count_off + len(bad), sampled)
