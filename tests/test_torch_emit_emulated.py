"""K6's source (csrc/emit.cu) run on the CPU under an emulation of CUDA
grids and blocks (tests/cuda_emu.h: one thread per CUDA thread, barriers,
warp shuffles, blocks in a scrambled order), against the plain
``ops/emit.emit_truecolor_fg_reference`` and the oracle.

It checks the kernel's logic: the tile sums (the colours staged with
16-byte loads, the predecessor across a tile edge and a row end, the
first cell's SGR), the emit launch's offsets from the sums of the tiles
before it, the warps' shuffle scans carried across their steps and across
warps, the digits without leading zeros, the staging buffer's head, body
and tail copied to the row, the reset and the length, and the zeroed tail
of every frame's buffer, which starts as noise, as does the tile-sum
scratch. Frames from 1 to 11,571 cells: smaller than a tile, tile edges
mid-row and on a row end, a run of one colour across a tile edge, ``TILE
± 1`` cells, batches of 1 to 9. The compiled kernel is checked on the card
(test_torch_kernels.py, chip_smoke.py). Tolerance: exact (bytes and
lengths)."""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.ops import emit, pixel
from asciichat_tpu_torch.render import oracle
from asciichat_tpu_torch.runtime import kernel_build

TESTS = Path(__file__).resolve().parent
# the two launches of ac_device_emit (kernel: its CTA's threads), each
# rewritten to an emulated grid
LAUNCH = {"tile_sums_kernel": "kSumThreads", "emit_tiles_kernel": "kThreads"}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ac_device_emit built by g++ from csrc/emit.cu with the CUDA grid
    emulated."""
    src = (kernel_build.CSRC_DIR / "emit.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    for kernel, threads in LAUNCH.items():
        src, n = re.subn(rf"{kernel}<<<blocks, {threads}, 0, s>>>\(",
                         f"EMU_LAUNCH_GRID({kernel}, blocks, {threads}, 0, ", src)
        assert n == 1, f"{kernel}'s launch line changed: update LAUNCH"
    out = tmp_path_factory.mktemp("emu")
    (out / "emit_emu.cpp").write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{TESTS}",
           "-o", str(out / "libemit_emu.so"), str(out / "emit_emu.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "libemit_emu.so"))
    lib.ac_device_emit.argtypes = kernel_build.ENTRY_POINTS["ac_device_emit"]
    lib.ac_device_emit.restype = ctypes.c_int
    return lib


def _luma(rgb: np.ndarray) -> np.ndarray:
    return pixel.luminance(torch.from_numpy(rgb)).to(torch.uint8).numpy()


def _emulated(lib, rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One emulated launch over rgb [B, H, W, 3] into a buffer of noise."""
    b, h, w, _ = rgb.shape
    rgb = np.ascontiguousarray(rgb)
    luma = _luma(rgb)
    tbl = emit.ascii_glyph_table()
    stride = emit.worst_bytes(h, w)
    noise = np.random.default_rng(h * w)
    data = noise.integers(1, 256, (b, stride), dtype=np.uint8)
    lengths = np.full(b, -1, np.int32)
    tile_sum = noise.integers(-2**31, 2**31, (b, emit.tiles(h, w)), dtype=np.int32)
    rc = lib.ac_device_emit(rgb.ctypes.data, luma.ctypes.data, tbl.ctypes.data, b, h, w,
                            data.ctypes.data, stride, lengths.ctypes.data,
                            tile_sum.ctypes.data, tile_sum.size, None)
    assert rc == 0
    return data, lengths


def _gradient(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) % 256],
                    -1).astype(np.uint8)


def _cases() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(11)
    flat = np.zeros((9, 31, 3), np.uint8)  # long runs: SGR only at their starts
    flat[:, :15] = [7, 200, 13]
    rows = np.zeros((6, 8, 3), np.uint8)  # each row one colour, the next row's the same
    rows[3:] = [40, 5, 250]
    return {
        "random_12x17": rng.integers(0, 256, (1, 12, 17, 3), dtype=np.uint8),
        "one_high": rng.integers(0, 256, (1, 1, 5, 3), dtype=np.uint8),
        "one_wide": rng.integers(0, 256, (1, 5, 1, 3), dtype=np.uint8),
        "flat_runs": flat[None],
        "rows_carry_state": rows[None],
        "black": np.zeros((1, 3, 4, 3), np.uint8),
        "single_digits": np.full((1, 4, 6, 3), 9, np.uint8),
        "three_digits": np.full((1, 4, 6, 3), 255, np.uint8),
        "batch_of_4": rng.integers(0, 256, (4, 10, 13, 3), dtype=np.uint8),
        # more cells than threads: every thread a run of cells, every warp a carry
        "mirror_57x203": np.stack([_gradient(57, 203),
                                   rng.integers(0, 256, (57, 203, 3), dtype=np.uint8)]),
        "mixed_runs_300x7": np.repeat(rng.integers(0, 4, (1, 300, 7, 1), dtype=np.uint8) * 60,
                                      3, axis=-1),
        # tiles: a frame smaller than one, an edge mid-row (1,024 = 5 x 200 +
        # 24) and one on a row end (1,024 = 16 x 64), a run of one colour
        # across an edge (no SGR at the second tile's first cell)
        "smaller_than_a_tile_20x30": rng.integers(0, 256, (1, 20, 30, 3), dtype=np.uint8),
        "edge_mid_row_9x200": rng.integers(0, 256, (1, 9, 200, 3), dtype=np.uint8),
        "edge_on_row_end_20x64": _runs(rng, (1, 20, 64)),
        "run_across_an_edge_2x1100": _run_across(rng, 1000, 1100),
        # cell counts about a warp and a tile
        "cells_1": rng.integers(0, 256, (1, 1, 1, 3), dtype=np.uint8),
        "cells_31": rng.integers(0, 256, (1, 31, 1, 3), dtype=np.uint8),
        "cells_33": rng.integers(0, 256, (1, 3, 11, 3), dtype=np.uint8),
        "cells_tile_minus_1": _runs(rng, (1, 3, emit.TILE // 3)),
        "cells_tile_plus_1": _runs(rng, (1, 5, (emit.TILE + 1) // 5)),
        "batch_of_9": np.concatenate([_gradient(23, 57)[None],
                                      _runs(rng, (8, 23, 57))]),
    }


def _runs(rng, shape: tuple) -> np.ndarray:
    """Random colours in runs of 1-6 cells (each cell a fresh colour with
    probability 0.4), so that some cells open and some do not."""
    fresh = rng.random(shape) < 0.4
    fresh.reshape(shape[0], -1)[:, 0] = True
    colours = rng.integers(0, 256, (*shape, 3), dtype=np.uint8).reshape(shape[0], -1, 3)
    flat = fresh.reshape(shape[0], -1)
    idx = np.maximum.accumulate(np.where(flat, np.arange(flat.shape[1]), 0), axis=1)
    return np.take_along_axis(colours, idx[..., None], axis=1).reshape(*shape, 3)


def _run_across(rng, start: int, stop: int) -> np.ndarray:
    """2 x 1,100 random cells with cells [start, stop) one colour."""
    rgb = rng.integers(0, 256, (1, 2 * 1100, 3), dtype=np.uint8)
    rgb[0, start:stop] = [12, 140, 250]
    return rgb.reshape(1, 2, 1100, 3)


@pytest.mark.parametrize("case", list(_cases()))
def test_emulated_k6_equals_plain_and_oracle(emulated, case):
    rgb = _cases()[case]
    data, lengths = _emulated(emulated, rgb)
    want, want_len = emit.emit_truecolor_fg_reference(
        torch.from_numpy(rgb), torch.from_numpy(_luma(rgb)),
        torch.from_numpy(emit.ascii_glyph_table()))
    np.testing.assert_array_equal(lengths, want_len.numpy())
    np.testing.assert_array_equal(data, want.numpy())  # the tail past each length too
    for i in range(rgb.shape[0]):
        assert data[i, :lengths[i]].tobytes() == oracle.render_truecolor_fg(rgb[i])


def test_tile_is_the_kernels():
    """The wrapper's tile count and scratch follow the kernel's kTile."""
    src = (kernel_build.CSRC_DIR / "emit.cu").read_text()
    assert re.search(rf"constexpr int kTile = {emit.TILE};", src)
    assert emit.tiles(57, 203) == 12 and emit.tiles(1, 1) == 1
    assert emit.tiles(1, emit.TILE) == 1 and emit.tiles(1, emit.TILE + 1) == 2


def test_emulated_k6_refuses_short_scratch(emulated):
    """A tile-sum scratch smaller than frames x tiles is refused, not written past."""
    rgb = np.zeros((2, 40, 40, 3), np.uint8)
    luma = _luma(rgb)
    tbl = emit.ascii_glyph_table()
    data = np.zeros((2, emit.worst_bytes(40, 40)), np.uint8)
    lengths = np.zeros(2, np.int32)
    scratch = np.zeros(4, np.int32)
    assert emit.tiles(40, 40) == 2
    rc = emulated.ac_device_emit(rgb.ctypes.data, luma.ctypes.data, tbl.ctypes.data, 2, 40, 40,
                                 data.ctypes.data, data.shape[1], lengths.ctypes.data,
                                 scratch.ctypes.data, 3, None)
    assert rc != 0
