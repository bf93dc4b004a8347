"""The renderer fuzz (tests/test_fuzz_render.py) on the card.

The 18 seeds of ``test_fuzz_full_convert`` (and, with
``ASCIICHAT_FUZZ_SEEDS=N``, the N seeds of its extended sweep) go through
the port's ``AsciiRenderer`` on the card and must equal the port's oracle
byte for byte. At every seed's shape K1 (``ops/resize.resize_nn``) and K2
(``ops/cells.render_cells``; K1 twice in the half-block RGB modes) are held
against their plain versions on the same card inputs, exactly, with their
launches counted: sources of 2-159 px, upscales, 3 palettes, 10
capabilities and ``wants_padding=False``.

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
