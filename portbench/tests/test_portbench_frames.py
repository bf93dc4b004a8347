"""The frame pool: the same seed gives the same frames, another seed others."""

from __future__ import annotations

import torch

from conftest import TINY_TRAFFIC
from harness.frames import make_pool

CPU = torch.device("cpu")


def test_pool_repeats_by_seed():
    a = make_pool(TINY_TRAFFIC, 2**31 + 12345, CPU)
    b = make_pool(TINY_TRAFFIC, 2**31 + 12345, CPU)
    assert torch.equal(a, b)
    assert a.dtype == torch.uint8
    count = TINY_TRAFFIC["batch"] * TINY_TRAFFIC["pool_batches"]
    assert tuple(a.shape) == (count, TINY_TRAFFIC["source_h"], TINY_TRAFFIC["source_w"], 3)


def test_another_seed_gives_other_frames():
    one, other = make_pool(TINY_TRAFFIC, 1, CPU), make_pool(TINY_TRAFFIC, 5_000_000_000, CPU)
    assert not torch.equal(one, other)


def test_frames_move_and_carry_noise():
    pool = make_pool(TINY_TRAFFIC, 7, CPU).to(torch.int16)
    assert not torch.equal(pool[0], pool[1])
    # neighbouring pixels of one frame differ almost everywhere, as on a camera
    assert (pool[:, :, 1:] != pool[:, :, :-1]).any(-1).float().mean() > 0.8
