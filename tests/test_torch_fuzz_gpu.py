"""The renderer fuzz (tests/test_fuzz_render.py) on the card.

The 18 seeds of ``test_fuzz_full_convert`` (and, with
``ASCIICHAT_FUZZ_SEEDS=N``, the N seeds of its extended sweep) go through
the port's ``AsciiRenderer`` on the card and must equal the port's oracle
byte for byte. At every seed's shape K1 (``ops/resize.resize_nn``) and K2
(``ops/cells.render_cells``; K1 twice in the half-block RGB modes) are held
against their plain versions on the same card inputs, exactly, with their
launches counted: sources of 2-159 px, upscales, 3 palettes, 10
capabilities and ``wants_padding=False``.

Pinned 1080p batches at the benchmark's two geometries go to the card as
their sampled source rows alone (``ops/ingest.py``) and must give the bytes
of the same frames already on the card, which skip the ingest; pageable and
upscaled batches go whole. The counters of ``render.ingest`` say which way
each call went.

The ``gpu`` tests skip where ``torch.cuda.is_available()`` is false; on
the card: ``python -m pytest --noconftest tests/test_torch_fuzz_gpu.py -m
gpu``. The file imports only the port, so it runs where JAX is not
installed. One CPU test holds this file's cases to the JAX file's draws.
"""

import os

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.ops import cells, pixel, resize
from asciichat_tpu_torch.render import oracle
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import AsciiRenderer, plan_render
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime.device import require_cuda
from asciichat_tpu_torch.utils import trace

# tests/test_fuzz_render.py's pools
CAPS_POOL = [
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.BACKGROUND),
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, wants_padding=False),
]
PALETTES = [pal.PALETTE_STANDARD, pal.PALETTE_BLOCKS, pal.PALETTE_MINIMAL]
CI_SEEDS = 18


def ci_case(seed: int) -> dict:
    """``test_fuzz_full_convert``'s case for ``seed``, drawn as it draws it."""
    rng = np.random.default_rng(1000 + seed)
    src_h = int(rng.integers(2, 90))
    src_w = int(rng.integers(2, 120))
    width = int(rng.integers(2, 70))
    height = int(rng.integers(2, 30))
    stretch = bool(rng.integers(0, 2))
    frame = rng.integers(0, 256, (src_h, src_w, 3), dtype=np.uint8)
    if seed % 3 == 0:
        frame[:, : src_w // 2] = frame[:, :1]  # long runs
    if seed % 4 == 0:
        frame[: src_h // 2] = 0  # transparency regions
    return dict(frame=frame, width=width, height=height, stretch=stretch,
                caps=CAPS_POOL[seed % len(CAPS_POOL)],
                palette=PALETTES[seed % len(PALETTES)])


def extended_case(seed: int) -> dict:
    """``test_fuzz_extended``'s case for ``seed`` (9000, 9001, ...)."""
    rng = np.random.default_rng(seed)
    src_h = int(rng.integers(2, 120))
    src_w = int(rng.integers(2, 160))
    width = int(rng.integers(2, 90))
    height = int(rng.integers(2, 40))
    stretch = bool(rng.integers(0, 2))
    frame = rng.integers(0, 256, (src_h, src_w, 3), dtype=np.uint8)
    if seed % 3 == 0:
        frame[:, : src_w // 2] = frame[:, :1]
    if seed % 5 == 0:
        frame[:] = 0
    return dict(frame=frame, width=width, height=height, stretch=stretch,
                caps=CAPS_POOL[seed % len(CAPS_POOL)],
                palette=PALETTES[seed % len(PALETTES)])


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return require_cuda()


def check_case(dev: torch.device, case: dict, renderers: dict, label: str) -> None:
    frame, caps, palette = case["frame"], case["caps"], case["palette"]
    width, height, stretch = case["width"], case["height"], case["stretch"]
    r = renderers.setdefault(palette, AsciiRenderer(palette, device=dev))
    got = r.convert(frame, width, height, caps, stretch=stretch)
    want = oracle.ascii_convert_with_capabilities(frame, width, height, caps,
                                                  stretch=stretch, palette=palette)
    assert got == want, f"{label}: {caps.renderer_key()} {frame.shape} -> {width}x{height}"

    # K1 and K2 against their plain versions at this case's shape
    plan = plan_render(frame.shape[1], frame.shape[0], width, height, caps, stretch=stretch)
    frames = torch.from_numpy(frame[None].copy()).to(dev)
    dh, dw = plan.dst_h_px, plan.dst_w
    plain = pixel.resize_nn(frames, dh, dw)
    k1 = resize.RESIZE_KERNEL.launches
    assert torch.equal(resize.resize_nn(frames, dh, dw), plain), label
    assert resize.RESIZE_KERNEL.launches == k1 + 1
    ramp = cells.ramp_for_palette(palette)
    k1, k2 = resize.RESIZE_KERNEL.launches, cells.CELL_RECORDS_KERNEL.launches
    records = cells.render_cells(frames, ramp, dst_h=dh, dst_w=dw, mode=plan.mode)
    hb_rgb = cells.mode_family(plan.mode) == cells.FAM_HB_RGB
    assert resize.RESIZE_KERNEL.launches == k1 + (2 if hb_rgb else 0)
    assert cells.CELL_RECORDS_KERNEL.launches == k2 + (0 if hb_rgb else 1)
    want_records = cells.records_for_mode(plain, plan.mode, ramp)
    assert list(records) == list(want_records)
    for k in want_records:
        assert torch.equal(records[k], want_records[k]), (label, plan.mode, k)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(CI_SEEDS))
def test_fuzz_full_convert_on_the_card(cuda, seed):
    check_case(cuda, ci_case(seed), {}, f"seed={seed}")


@pytest.mark.gpu
def test_fuzz_extended_on_the_card(cuda):
    n = int(os.environ.get("ASCIICHAT_FUZZ_SEEDS", "0"))
    if not n:
        pytest.skip("set ASCIICHAT_FUZZ_SEEDS=N to run the extended sweep")
    renderers: dict = {}
    for seed in range(9000, 9000 + n):
        check_case(cuda, extended_case(seed), renderers, f"seed={seed}")


# The benchmark's cells: 1080p -> 203x64 with the aspect kept, 57 and 114
# sampled pixel rows of 1,920 x 3 bytes, batches of 128.
BENCH_CAPS = {"truecolor": (TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND), 57),
              "halfblock": (TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK), 114)}
INGEST = ("ingest_row_batches", "ingest_whole_batches", "ingest_rows", "bytes")


def ingest_counts(fn) -> dict[str, int]:
    """What ``fn()`` adds to the ``render.ingest`` counters."""
    before = trace.PROCESS.counters()
    fn()
    after = trace.PROCESS.counters()
    return {k: after.get(f"render.ingest.{k}", 0) - before.get(f"render.ingest.{k}", 0)
            for k in INGEST}


def pinned_frames(dev: torch.device, n: int, h: int, w: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    frames = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=dev, generator=gen)
    host = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(frames)
    return host


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(BENCH_CAPS))
def test_pinned_batches_take_the_row_path_on_the_card(cuda, cell):
    caps, rows = BENCH_CAPS[cell]
    host = pinned_frames(cuda, 128, 1080, 1920, seed=rows)
    r = AsciiRenderer(device=cuda)
    out: list = []
    counts = ingest_counts(lambda: out.append(r.convert_batch(host, 203, 64, caps)))
    assert counts == {"ingest_row_batches": 1, "ingest_whole_batches": 0,
                      "ingest_rows": rows, "bytes": 128 * rows * 1920 * 3}
    assert counts["bytes"] == {57: 42_024_960, 114: 84_049_920}[rows]
    on_card = host.to(cuda)
    counts = ingest_counts(lambda: out.append(r.convert_batch(on_card, 203, 64, caps)))
    assert counts["ingest_row_batches"] == 0 and counts["ingest_whole_batches"] == 1
    assert out[0] == out[1]
    # every other frame of the pinned batch: frames two frames apart
    counts = ingest_counts(lambda: out.append(r.convert_batch(host[1::2], 203, 64, caps)))
    assert counts["ingest_row_batches"] == 1
    assert out[2] == out[1][1::2]


@pytest.mark.gpu
def test_pageable_and_upscaled_batches_go_whole_on_the_card(cuda):
    caps, _ = BENCH_CAPS["truecolor"]
    r = AsciiRenderer(device=cuda)
    pinned = pinned_frames(cuda, 8, 1080, 1920, seed=8)
    want = r.convert_batch(pinned, 203, 64, caps)
    out: list = []
    counts = ingest_counts(lambda: out.append(r.convert_batch(pinned.numpy().copy(), 203, 64,
                                                              caps)))
    assert counts == {"ingest_row_batches": 0, "ingest_whole_batches": 1, "ingest_rows": 0,
                      "bytes": pinned.nbytes}
    assert out[0] == want
    small = pinned_frames(cuda, 2, 16, 16, seed=16)
    counts = ingest_counts(lambda: out.append(r.convert_batch(small, 203, 64, caps)))
    assert counts["ingest_row_batches"] == 0 and counts["ingest_whole_batches"] == 1
    frames = small.numpy()
    assert out[1] == [oracle.ascii_convert_with_capabilities(f, 203, 64, caps) for f in frames]


def test_cases_are_the_jax_fuzz_draws(monkeypatch):
    """The JAX file's fuzz, compiled on the port, converts exactly this
    file's cases (its renderer and oracle replaced by a recorder)."""
    from test_torch_webrtc import port_jax_tests

    ns: dict = {}
    port_jax_tests(ns, "test_fuzz_render.py")
    calls: list[dict] = []

    class Recorder:
        def __init__(self, palette):
            self.palette = palette

        def convert(self, frame, width, height, caps, stretch=False):
            calls.append(dict(frame=frame.copy(), width=width, height=height,
                              stretch=stretch, caps=caps, palette=self.palette))
            return b""

    class Oracle:
        @staticmethod
        def ascii_convert_with_capabilities(*args, **kwargs):
            return b""

    fuzz = ns["test_fuzz_full_convert"]
    module = fuzz.__globals__
    module["AsciiRenderer"], module["oracle"] = Recorder, Oracle
    for seed in range(CI_SEEDS):
        fuzz(seed)
    monkeypatch.setenv("ASCIICHAT_FUZZ_SEEDS", "40")
    ns["test_fuzz_extended"]()
    mine = [ci_case(s) for s in range(CI_SEEDS)] + [extended_case(s)
                                                     for s in range(9000, 9040)]
    assert len(calls) == len(mine)
    for got, want in zip(calls, mine):
        assert np.array_equal(got.pop("frame"), want.pop("frame"))
        assert got == want
