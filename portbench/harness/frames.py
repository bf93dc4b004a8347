"""The frame pool of a run: synthetic video made on the device from the seed.

Each frame is a smooth background gradient that drifts from frame to frame,
a few filled discs that move in straight lines (drawn wrapped at the edges,
so each is whole in every frame) and per-pixel sensor noise, all set by the
traffic file's ``content``. Each disc's size, speed and colour are the
file's; only the gradient's phases and the discs' places and directions come
from the seed. With whole gradient cycles across the frame, every seed asks
the same work of the program: the same colours over the same areas, placed
elsewhere (the bytes of a frame follow the digits of its colours). The pool
is made a chunk of frames at a time and copied into host memory, pinned
where the device is a card, as a capture or decode stage would hand frames
over.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, device: torch.device, n: int, lo: float,
             hi: float) -> list[float]:
    return (lo + (hi - lo) * torch.rand(n, generator=gen, device=device)).tolist()


def make_pool(traffic: dict, seed: int, device: torch.device) -> torch.Tensor:
    """uint8 [pool_batches * batch, source_h, source_w, 3] on the host."""
    h, w = traffic["source_h"], traffic["source_w"]
    count = traffic["pool_batches"] * traffic["batch"]
    c = traffic["content"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phases = _uniform(gen, device, 3, 0.0, 1.0)
    discs = len(c["discs"])
    cx = _uniform(gen, device, discs, 0.0, w)
    cy = _uniform(gen, device, discs, 0.0, h)
    angle = _uniform(gen, device, discs, 0.0, 2 * math.pi)
    speed = [d["speed"] for d in c["discs"]]
    radius = [d["radius"] * h for d in c["discs"]]
    colours = torch.tensor([d["colour"] for d in c["discs"]], dtype=torch.float32,
                           device=device)

    pool = torch.empty((count, h, w, 3), dtype=torch.uint8, pin_memory=device.type == "cuda")
    x = torch.arange(w, device=device, dtype=torch.float32) / w
    y = torch.arange(h, device=device, dtype=torch.float32) / h
    xs = torch.arange(w, device=device, dtype=torch.float32)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    amp, drift = c["gradient_amplitude"], c["gradient_drift"]
    fr, fg, fb = c["gradient_cycles"]
    two_pi = 2 * math.pi
    for t0 in range(0, count, c["chunk_frames"]):
        t = torch.arange(t0, min(count, t0 + c["chunk_frames"]), device=device,
                         dtype=torch.float32)[:, None, None]
        n = t.shape[0]
        red = 128 + amp * torch.sin(two_pi * (fr * x + phases[0] + drift * t))
        green = 128 + amp * torch.sin(two_pi * (fg * y[:, None] + phases[1] - drift * t))
        blue = 128 + amp * torch.sin(two_pi * (fb * (x + y[:, None]) + phases[2] + 0.5 * drift * t))
        img = torch.stack([red.expand(n, h, w), green.expand(n, h, w), blue.expand(n, h, w)], -1)
        for k in range(discs):
            px = cx[k] + speed[k] * math.cos(angle[k]) * t
            py = cy[k] + speed[k] * math.sin(angle[k]) * t
            dx = torch.remainder(xs - px + w / 2, w) - w / 2
            dy = torch.remainder(ys[:, None] - py + h / 2, h) - h / 2
            inside = dx ** 2 + dy ** 2 < radius[k] ** 2
            img = torch.where(inside[..., None], colours[k], img)
        img += c["noise_sigma"] * torch.randn(img.shape, generator=gen, device=device)
        pool[t0:t0 + n].copy_(img.round_().clamp_(0, 255).to(torch.uint8))
    return pool
