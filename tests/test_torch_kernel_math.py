"""The CUDA kernels' per-element math (csrc/cells_math.cuh), compiled by g++
into a CPU library, against the port's plain PyTorch versions over all 2^24
RGB triples: luma, mono key, 256- and 16-colour quantize, and the colour
filter of every registry entry. Tolerance: exact equality."""

import ctypes

import numpy as np
import pytest
import torch

from asciichat_tpu.render import palette as pal
from asciichat_tpu_torch.ops import cells, filters, pixel
from asciichat_tpu_torch.runtime import kernel_build

CHUNK = 1 << 16  # triples per comparison: the temporaries stay in cache


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lib():
    return kernel_build.cells_math_lib()


@pytest.fixture(scope="module")
def all_rgb() -> np.ndarray:
    """Every RGB triple once, uint8 [2^24, 3]."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], axis=-1).astype(np.uint8)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _chunks(all_rgb):
    for start in range(0, len(all_rgb), CHUNK):
        yield np.ascontiguousarray(all_rgb[start:start + CHUNK])


PER_PIXEL = {
    "cm_luma": lambda px: pixel.luminance(px).to(torch.uint8),
    "cm_q256": pixel.quantize_256,
    "cm_q16": pixel.quantize_16,
}


@pytest.mark.parametrize("fn", list(PER_PIXEL))
def test_per_pixel_math_exhaustive(lib, all_rgb, fn):
    out = np.empty(CHUNK, np.uint8)
    for rgb in _chunks(all_rgb):
        getattr(lib, fn)(_ptr(rgb), len(rgb), _ptr(out))
        want = PER_PIXEL[fn](torch.from_numpy(rgb)).numpy()
        np.testing.assert_array_equal(out[:len(rgb)], want)


@pytest.mark.parametrize("palette", ["standard", "blocks"])
def test_mono_key_exhaustive(lib, all_rgb, palette):
    ramp = cells.ramp_for_palette(pal.BUILTIN_PALETTES[palette])
    ramp_np = np.ascontiguousarray(ramp.numpy())
    out = np.empty(CHUNK, np.uint8)
    for rgb in _chunks(all_rgb):
        lib.cm_mono_key(_ptr(rgb), len(rgb), _ptr(ramp_np), _ptr(out))
        want = pixel.mono_keys(torch.from_numpy(rgb), ramp).numpy()
        np.testing.assert_array_equal(out[:len(rgb)], want)


@pytest.mark.parametrize("name", filters.FILTER_NAMES)
def test_color_filter_exhaustive(lib, all_rgb, name):
    tint, fg_on_bg, rainbow, enabled = filters.filter_params([name], time_s=1.3)
    params = [torch.from_numpy(p) for p in (tint, fg_on_bg, rainbow, enabled)]
    out = np.empty((CHUNK, 3), np.uint8)
    for rgb in _chunks(all_rgb):
        lib.cm_color_filter(_ptr(rgb), len(rgb), *(int(c) for c in tint[0]),
                            int(fg_on_bg[0]), int(rainbow[0]), int(enabled[0]),
                            _ptr(out))
        want = filters.apply_color_filter(torch.from_numpy(rgb)[None, :, None], *params)
        np.testing.assert_array_equal(out[:len(rgb)], want[0, :, 0].numpy())


@pytest.mark.parametrize("hpx", [1, 2, 7, 8, 128])
def test_halfblock_rows(lib, hpx):
    rows = (hpx + 1) // 2
    got = [lib.cm_hb_bot_row(r, hpx) for r in range(rows)]
    assert got == [min(2 * r + 1, hpx - 1) for r in range(rows)]


def test_pixel_offset_is_64_bit(lib):
    b, h, w = 128, 1080, 1920
    assert lib.cm_pixel_offset(b - 1, h, w, h - 1, w - 1) == (b * h * w - 1) * 3
    # frame 700 of a 1080p batch starts past 2^31 bytes: int32 would wrap
    assert lib.cm_pixel_offset(700, h, w, 5, 7) == ((700 * h + 5) * w + 7) * 3 > 2**31
