"""K1's and K2's sources run on the CPU under an emulation of CUDA grids and
blocks (tests/cuda_emu.h: one thread per CUDA thread, barriers, blocks in a
scrambled order), fed by the port's own host side (ops/resize.IndexTables,
ops/cells.cell_tables and allocate_records), against the plain
``pixel.resize_nn`` (K1) and ``cells.records_for_mode(pixel.resize_nn(...))``
(K2, all 10 modes; the two half-block RGB modes as two K1 launches, as
``render_cells`` makes them). Two designs, through the same C entry points:
the package's (csrc/resize.cu, csrc/cell_records.cu, csrc/records.cuh: a
thread per output pixel) and the row-staging design that was measured and
not shipped (tools/k12_staged: a persistent grid of EMU_SMS x
EMU_BLOCKS_PER_SM warps, each sampled row copied into a ring of
shared-memory slots by one bulk copy on an mbarrier). The package's kernels
also run on the compact batch that the row ingest makes (design ``rows``:
csrc/ingest.cu's ac_copy_rows, one cudaMemcpy2DAsync a sampled row, emulated
as a loop of line copies, then K2 or K1 through ops/cells.row_tables),
against the same kernels on the full frames and the plain versions.

The staged design in three builds: the copies land only when a wait
retires them (a read that is not waited for sees the stage's noise); they
land at once when issued (``EMU_COPY_EARLY``: a copy into a ring slot that
other threads still read shows in their records); and a stage of 64 bytes
(``AC_MAX_SPAN``), so that every row is cut into column tiles found by the
binary search. Its launches are held to their opt-in to dynamic shared
memory past 48 KB, as the card holds them.

Shapes: batches of 1 to 9; odd source widths, whose rows start at every
phase mod 16; frames placed at an address that is not 16-byte aligned, so
that the first granule is read byte by byte and the last one zero-filled;
640x480 (the webcam's) and 1080p rows at the mirror's geometry; 4K rows
(3840 -> 203 columns, a step of 56.7 bytes); fewer items than CTAs;
upscales; more output columns than a tile; rows longer than a stage. Every
record buffer starts as noise, so a byte left unwritten shows. The compiled
kernels are checked on the card (test_torch_kernels.py,
test_torch_fuzz_gpu.py, chip_smoke.py). Tolerance: exact (uint8 records)."""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.ops import cells, ingest, pixel, resize
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.runtime import kernel_build

TESTS = Path(__file__).resolve().parent
STAGED = TESTS.parent / "tools" / "k12_staged"
CPU = torch.device("cpu")
# each design's sources: file -> (directory, the launches rewritten for the emulation)
PACKAGE = {
    "resize.cu": (kernel_build.CSRC_DIR, [(
        r"resize_kernel<<<\(unsigned\)blocks, threads, 0, \(cudaStream_t\)stream>>>\(",
        "EMU_LAUNCH_GRID(resize_kernel, (int)blocks, threads, 0, ")]),
    "cell_records.cu": (kernel_build.CSRC_DIR, []),
    "records.cuh": (kernel_build.CSRC_DIR, [(
        r"records_kernel<FAM, Src><<<\(unsigned\)blocks, threads, 0, stream>>>\(",
        "EMU_LAUNCH_GRID((records_kernel<FAM, Src>), (int)blocks, threads, 0, ")]),
    "cells_math.cuh": (kernel_build.CSRC_DIR, []),
    "ingest.cu": (kernel_build.CSRC_DIR, []),
}
STAGED_SOURCES = {
    "resize.cu": (STAGED, []),
    "cell_records.cu": (STAGED, []),
    "records.cuh": (STAGED, []),
    "row_stage.cuh": (STAGED, [
        (r"row_stage_kernel<Epi><<<\(unsigned\)grid, kThreads, smem, stream>>>\(",
         "EMU_LAUNCH_GRID_LIMITED(row_stage_kernel<Epi>, (int)grid, kThreads, smem, "),
        (r"extern __shared__ __align__\(16\) uint8_t smem\[\];",
         "uint8_t* const smem = static_cast<uint8_t*>(emu_dynamic_smem);")]),
    "cells_math.cuh": (kernel_build.CSRC_DIR, []),
}
# build -> (sources, g++ flags)
BUILDS = {"package": (PACKAGE, ()), "wait": (STAGED_SOURCES, ()),
          "early": (STAGED_SOURCES, ("-DEMU_COPY_EARLY",)),
          "short_stage": (STAGED_SOURCES, ("-DAC_MAX_SPAN=64",))}
# design -> (its build of record, whether the frames go in as their sampled
# rows through ac_copy_rows, as AsciiRenderer.convert_batch sends pinned frames)
DESIGNS = {"package": ("package", False), "staged": ("wait", False), "rows": ("package", True)}
ENTRIES = ("ac_resize_nn", "ac_cell_records", "ac_copy_rows")


def _write_sources(out: Path, sources: dict) -> None:
    for name, (directory, rewrites) in sources.items():
        src = (directory / name).read_text()
        for pattern, repl in rewrites:
            src, n = re.subn(pattern, repl, src)
            assert n == 1, f"{name} no longer matches {pattern!r}: update the test"
        (out / name.replace(".cu", ".cpp") if name.endswith(".cu") else out / name).write_text(src)
    (out / "cuda_runtime.h").write_text('#pragma once\n#include "cuda_emu.h"\n')
    (out / "cuda_pipeline.h").write_text("#pragma once\n")  # cuda_emu.h has the pipeline


def _build(out: Path, flags: tuple) -> subprocess.Popen:
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           "-DEMU_SPIN_BARRIER", *flags, f"-I{out}", f"-I{TESTS}", "-o",
           str(out / "lib.so"), *map(str, sorted(out.glob("*.cpp")))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def libs(tmp_path_factory) -> dict[str, ctypes.CDLL]:
    """ac_resize_nn and ac_cell_records (and the package's ac_copy_rows)
    built by g++ from each design's sources with the CUDA grid emulated, once
    per entry of BUILDS."""
    root = tmp_path_factory.mktemp("emu")
    jobs = {}
    for name, (sources, flags) in BUILDS.items():
        out = root / name
        out.mkdir()
        _write_sources(out, sources)
        jobs[name] = _build(out, flags)
    built = {}
    for name, job in jobs.items():
        text = job.communicate(timeout=600)[0]
        assert job.returncode == 0, text[-4000:]
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for entry in filter(lambda e: hasattr(lib, e), ENTRIES):
            fn = getattr(lib, entry)
            fn.argtypes = kernel_build.ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
        built[name] = lib
    return built


class Frames:
    """A uint8 [b, h, w, 3] batch placed ``offset`` bytes past a 16-byte
    boundary, kept alive with its buffer."""

    def __init__(self, b: int, h: int, w: int, seed: int, offset: int = 0):
        rng = np.random.default_rng(seed)
        n = b * h * w * 3
        self.buf = np.empty(n + 64, np.uint8)
        start = (-self.buf.ctypes.data) % 16 + offset
        self.array = self.buf[start:start + n].reshape(b, h, w, 3)
        self.array[...] = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        self.array[0, 0, :2] = 0  # a black pixel pair for the transparent flag
        assert self.array.ctypes.data % 16 == offset % 16
        self.tensor = torch.from_numpy(self.array)


def _noise(t: torch.Tensor, seed: int) -> torch.Tensor:
    t.copy_(torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, tuple(t.shape), dtype=np.uint8)))
    return t


def emulated_resize(lib, frames: np.ndarray, tables: resize.IndexTables) -> torch.Tensor:
    b, h, w, _ = frames.shape
    dh, dw = tables.sy.shape[0], tables.sx.shape[0]
    out = _noise(torch.empty((b, dh, dw, 3), dtype=torch.uint8), dh * dw)
    rc = lib.ac_resize_nn(frames.ctypes.data, b, h, w, tables.sy.data_ptr(), dh,
                          tables.sx.data_ptr(), dw, out.data_ptr(), None)
    assert rc == 0
    return out


def emulated_copy_rows(lib, frames: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """What ops/ingest.copy_rows queues on a card, emulated: frames[:, rows]
    into a compact batch that starts as noise."""
    b, _, w, _ = frames.shape
    layout = ingest.row_layout(torch.from_numpy(frames))
    assert layout is not None
    out = _noise(torch.empty((b, len(rows), w, 3), dtype=torch.uint8), len(rows)).numpy()
    host_rows = np.ascontiguousarray(rows, np.int32)
    rc = lib.ac_copy_rows(frames.ctypes.data, b, *layout, w * 3, host_rows.ctypes.data,
                          len(host_rows), out.ctypes.data, None)
    assert rc == 0
    return out


def emulated_records(lib, frames: np.ndarray, tables: cells.CellTables, mode: str,
                     ramp: torch.Tensor) -> dict[str, torch.Tensor]:
    """What render_cells launches for ``mode``, emulated."""
    family = cells.mode_family(mode)
    if family == cells.FAM_HB_RGB:
        return {"top": emulated_resize(lib, frames, tables.top),
                "bot": emulated_resize(lib, frames, tables.bot)}
    b, h, w, _ = frames.shape
    dh, dw = tables.resize.sy.shape[0], tables.resize.sx.shape[0]
    records = cells.allocate_records(family, b, dh, dw, CPU)
    for i, t in enumerate(records.values()):
        _noise(t, i)
    rc = lib.ac_cell_records(family, frames.ctypes.data, b, h, w, tables.resize.sy.data_ptr(),
                             dh, tables.resize.sx.data_ptr(), dw, ramp.data_ptr(),
                             *cells.record_pointers(records), None)
    assert rc == 0
    return records


# name: (batch, src_h, src_w, dst_h px, dst_w, the frames' address mod 16)
CASES = {
    "b1_odd_37x53": (1, 37, 53, 20, 31, 5),
    **{f"b{b}_odd_61x83": (b, 61, 83, 21, 37, b) for b in range(2, 10)},
    "webcam_640x480": (1, 480, 640, 64, 171, 0),
    "rows_1080p": (1, 1080, 1920, 57, 203, 0),
    "halfblock_rows_1080p": (1, 1080, 1920, 114, 203, 0),
    "rows_4k": (1, 2160, 3840, 57, 203, 0),
    "rows_4k_unaligned": (1, 2160, 3840, 23, 203, 3),
    "fewer_items_than_ctas": (1, 10, 12, 3, 5, 7),
    "upscale_16x16": (2, 16, 16, 40, 80, 9),
    "upscale_odd_end": (1, 7, 5, 9, 13, 1),
    "columns_past_a_tile": (1, 6, 1400, 5, 1100, 2),
    "rows_split_among_warps": (1, 30, 700, 2, 200, 6),
    "one_pixel": (1, 1, 1, 1, 1, 15),
}
# cases for the build whose copies land at issue, and the short-stage build
LANDING_EARLY = ("b3_odd_61x83", "rows_1080p", "rows_4k", "upscale_16x16")
SHORT_STAGE = {
    "dense_rows": (2, 9, 300, 7, 70, 4),
    "wide_steps": (1, 12, 800, 11, 15, 0),
    "wide_steps_odd": (2, 5, 997, 5, 29, 11),
    "columns_past_a_tile": (1, 3, 1400, 3, 1100, 0),
}


def _check_case(lib, spec: tuple, mode: str, rows: bool = False) -> None:
    """The emulated records of ``spec`` in ``mode`` against the plain ones;
    with ``rows``, also against the same build's kernels on the full frames,
    and the kernels read the sampled rows that ac_copy_rows moved."""
    b, h, w, dh, dw, offset = spec
    f = Frames(b, h, w, seed=h * w + b, offset=offset)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    tables = cells.cell_tables(h, w, dh, dw, CPU)
    want = cells.records_for_mode(pixel.resize_nn(f.tensor, dh, dw), mode, ramp)
    if rows:
        sampled, compact = cells.row_tables(h, w, dh, dw, CPU)
        got = emulated_records(lib, emulated_copy_rows(lib, f.array, sampled), compact, mode, ramp)
        whole = emulated_records(lib, f.array, tables, mode, ramp)
        assert list(got) == list(whole)
        for k in whole:
            assert torch.equal(got[k], whole[k]), k
    else:
        got = emulated_records(lib, f.array, tables, mode, ramp)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", cells.MODES)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("design", list(DESIGNS))
def test_emulated_k2_equals_plain(libs, design, case, mode):
    build, rows = DESIGNS[design]
    _check_case(libs[build], CASES[case], mode, rows)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("design", list(DESIGNS))
def test_emulated_k1_equals_plain(libs, design, case):
    b, h, w, dh, dw, offset = CASES[case]
    f = Frames(b, h, w, seed=h + w, offset=offset)
    build, rows = DESIGNS[design]
    lib = libs[build]
    if rows:
        sampled, compact = cells.row_tables(h, w, dh, dw, CPU)
        got = emulated_resize(lib, emulated_copy_rows(lib, f.array, sampled), compact.resize)
        assert torch.equal(got, emulated_resize(lib, f.array,
                                                resize.resize_tables(h, w, dh, dw, CPU)))
    else:
        got = emulated_resize(lib, f.array, resize.resize_tables(h, w, dh, dw, CPU))
    assert torch.equal(got, pixel.resize_nn(f.tensor, dh, dw))


@pytest.mark.parametrize("mode", ["truecolor_fg", "halfblock_256", "16color"])
@pytest.mark.parametrize("case", LANDING_EARLY)
def test_emulated_k2_copies_landing_early(libs, case, mode):
    _check_case(libs["early"], CASES[case], mode)


@pytest.mark.parametrize("mode", ["truecolor_fg", "halfblock_16", "halfblock_mono", "mono"])
@pytest.mark.parametrize("case", list(SHORT_STAGE))
def test_emulated_k2_rows_longer_than_a_stage(libs, case, mode):
    _check_case(libs["short_stage"], SHORT_STAGE[case], mode)


def test_cases_reach_the_staging_paths():
    """The cases above start rows at every phase, step over a sector, and
    read the frames' first and last granules partially."""
    def table(case):
        _, h, w, dh, dw, _ = CASES[case]
        return resize.resize_tables(h, w, dh, dw, CPU)
    # 83 * 3 bytes a row: consecutive rows' spans start at every address mod 16
    assert {(r * 83 * 3) % 16 for r in range(61)} == set(range(16))
    # 4K rows step over one 32-byte sector a column, 1080p rows under one
    assert 3 * float(table("rows_4k").sx.double().diff().mean()) > 32
    assert 3 * float(table("rows_1080p").sx.double().diff().mean()) < 32
    # the upscales sample the frames' last pixel, whose granule ends past them
    for case in ("upscale_16x16", "upscale_odd_end"):
        t = table(case)
        b, h, w, _, _, offset = CASES[case]
        assert t.sy[-1] == h - 1 and t.sx[-1] == w - 1 and (offset + b * h * w * 3) % 16


def test_emulated_staged_opt_in_never_falls(libs):
    """Two sources of 8,190 pixels a row, whose rings need more than 48 KB
    of dynamic shared memory (49,872 and 49,280 bytes, remembered in two
    ways of the size cache), launched in turns: the smaller launch must not
    lower the opt-in below what the larger one, found in the cache, needs."""
    f = Frames(1, 8, 8190, seed=8190)
    for dw in (200, 5, 200, 5):
        tables = resize.resize_tables(8, 8190, 8, dw, CPU)
        got = emulated_resize(libs["wait"], f.array, tables)
        assert torch.equal(got, pixel.resize_nn(f.tensor, 8, dw)), dw
