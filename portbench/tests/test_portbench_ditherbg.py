"""The plain reference of the background render mode (reference/modes/
16color_dithered_bg.py): byte for byte against the port's CPU path and its
oracle, its wavefront dither against a raster loop, and the cell's geometry
and yardstick."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import yardstick
from reference.render import Reference, load_mode

STANDARD = "   ...',;:clodxkO0KXNWM"
BLOCKS = "   ░░▒▒▓▓██"  # multi-byte glyphs
MODE = "16color_dithered_bg"
ditherbg = load_mode(MODE)


def config(width: int, height: int, palette: str = STANDARD) -> dict:
    return {"mode": MODE, "palette": palette, "width": width, "height": height,
            "keep_aspect": True, "padding": True}


def frames(h: int, w: int, seed: int) -> np.ndarray:
    """Noise, flat blocks, few-valued noise and saturated noise (errors past
    0..255 carried on) in one batch."""
    rng = np.random.default_rng(seed)
    out = np.zeros((4, h, w, 3), np.uint8)
    out[0] = rng.integers(0, 256, (h, w, 3))
    out[1] = 40
    out[1, h // 4: h // 2, w // 5: w // 2] = 0
    out[1, h // 2:, w // 2:] = (200, 10, 90)
    out[2] = rng.integers(0, 3, (h, w, 1)) * 60
    out[3] = rng.integers(0, 2, (h, w, 3)) * 255
    return out


def c_div16(v: int) -> int:
    return int(v / 16)  # toward zero, as C divides


def raster_dither(pixels: np.ndarray) -> np.ndarray:
    """rgb_to_16color_dithered (ansi.c:511-583) as C runs it: one cell at a
    time in raster order."""
    h, w, _ = pixels.shape
    colours = ditherbg.COLOURS.tolist()
    err = [[[0, 0, 0] for _ in range(w)] for _ in range(h)]
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            value = [int(pixels[y, x, c]) + err[y][x][c] for c in range(3)]
            clamped = [min(255, max(0, v)) for v in value]
            dist = [sum((clamped[c] - col[c]) ** 2 for c in range(3)) for col in colours]
            index = dist.index(min(dist))
            out[y, x] = index
            e = [value[c] - colours[index][c] for c in range(3)]
            for dy, dx, k in ((0, 1, 7), (1, -1, 3), (1, 0, 5), (1, 1, 1)):
                if 0 <= x + dx < w and y + dy < h:
                    for c in range(3):
                        err[y + dy][x + dx][c] += c_div16(e[c] * k)
    return out


def port_frames(batch: np.ndarray, width: int, height: int, palette: str) -> list[bytes]:
    from asciichat_tpu_torch.render.pipeline import AsciiRenderer
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.BACKGROUND)
    assert caps.renderer_key() == MODE
    return AsciiRenderer(palette=palette, device="cpu").convert_batch(batch, width, height, caps)


@pytest.mark.parametrize("palette", [STANDARD, BLOCKS])
@pytest.mark.parametrize("shape", [(48, 80, 40, 12), (45, 61, 17, 9), (1080, 1920, 203, 64)])
def test_reference_equals_the_port_on_the_cpu(shape, palette):
    h, w, width, height = shape
    batch = frames(h, w, seed=h * w)
    ref = Reference(config(width, height, palette), h, w)
    assert [ref.frame(f) for f in batch] == port_frames(batch, width, height, palette)


@pytest.mark.parametrize("palette", [STANDARD, BLOCKS])
@pytest.mark.parametrize("shape", [(12, 40), (9, 17), (1, 7), (5, 1), (57, 203)])
def test_reference_equals_the_ports_oracle(shape, palette):
    from asciichat_tpu_torch.render import oracle
    for pixels in frames(*shape, seed=sum(shape)):
        assert ditherbg.render(pixels, palette) == oracle.render_16color_dithered_bg(
            pixels, True, palette)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (6, 1), (2, 2), (7, 4), (12, 40), (23, 31)])
def test_wavefront_dither_equals_the_raster_loop(shape):
    for pixels in frames(*shape, seed=7 * shape[0] + shape[1]):
        assert np.array_equal(ditherbg.dither(pixels), raster_dither(pixels))


def test_a_hand_worked_row():
    """Two cells of (100, 100, 100): the first is grey 8 (128, 128, 128) with
    an error of -28 a channel, so the second gets (-28 * 7) / 16 = -12 and
    reads 88, grey 8 again; grey 8's luma, 128, is not under 127, so black
    (30) on bright black (100), and the glyph of luminance 100."""
    from reference.palette import luminance_glyphs
    pixels = np.full((1, 2, 3), 100, np.uint8)
    assert ditherbg.dither(pixels).tolist() == [[8, 8]]
    glyph = luminance_glyphs(STANDARD)[100]
    assert ditherbg.render(pixels, STANDARD) == (b"\x1b[100m\x1b[30m" + glyph) * 2 + b"\x1b[0m"


def test_geometry_and_yardstick_of_the_cell():
    conf = json.loads((BENCH_DIR / "configs" / "ditherbg-203x64.json").read_text())
    tc = json.loads((BENCH_DIR / "configs" / "truecolor-203x64.json").read_text())
    ref = Reference(conf, 1080, 1920)
    assert (ref.cells_w, ref.pixel_rows, ref.pad_w, ref.pad_h) == (203, 57, 0, 3)
    # K2's records are truecolor_fg's: rgb and luma, 4 B a cell
    assert yardstick.records_bytes(ref, 128) == yardstick.records_bytes(Reference(tc, 1080, 1920),
                                                                        128)
    assert conf["process"] == tc["process"] and conf["reduced"] == []
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
    caps = TerminalCapabilities(ColorLevel[conf["color_level"]], RenderMode[conf["render_mode"]])
    assert caps.renderer_key() == conf["mode"] == MODE
