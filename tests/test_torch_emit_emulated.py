"""K6's source (csrc/emit.cu) run on the CPU under an emulation of CUDA
grids and blocks (tests/cuda_emu.h: one thread per CUDA thread, barriers,
warp shuffles, blocks in a scrambled order), against the plain
``ops/emit.emit_truecolor_fg_reference`` and the oracle.

It checks the kernel's logic: each thread's run of cells and its byte sum,
the block scan (warp shuffles, then the warp totals), the SGR decision
against the raster predecessor (across row ends, the first cell always),
the digits without leading zeros, the reset and the length, and the zeroed
tail of every frame's buffer, which starts as noise. The compiled kernel is
checked on the card (test_torch_kernels.py, chip_smoke.py). Tolerance:
exact (bytes and lengths)."""

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
LAUNCH = r"emit_kernel<<<batch, kThreads, 0, \(cudaStream_t\)stream>>>\("


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ac_device_emit built by g++ from csrc/emit.cu with the CUDA grid
    emulated."""
    src = (kernel_build.CSRC_DIR / "emit.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, n = re.subn(LAUNCH, "EMU_LAUNCH_GRID(emit_kernel, batch, kThreads, 0, ", src)
    assert n == 1, "the kernel's launch line changed: update LAUNCH"
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
    data = np.random.default_rng(h * w).integers(1, 256, (b, stride), dtype=np.uint8)
    lengths = np.full(b, -1, np.int32)
    rc = lib.ac_device_emit(rgb.ctypes.data, luma.ctypes.data, tbl.ctypes.data, b, h, w,
                            data.ctypes.data, stride, lengths.ctypes.data, None)
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
    }


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
