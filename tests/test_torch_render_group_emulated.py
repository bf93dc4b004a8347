"""K3's source (csrc/render_group.cu) run on the CPU under an emulation of
CUDA grids and blocks (tests/cuda_emu.h: threads, barriers, blocks in a
scrambled order, cp.async copies that land only when waited for), fed by the
port's own host side (models/server.RecordArena, k3_tables, tile_width,
compositor.pixel_words), against the plain render_compute.

Cases: every record family; one to three groups in one launch of
different geometry, family and receiver count (1 to 13, rainbow among
them), with and without tiles that split a cell row; a group of 20
receivers (two descriptors); 18 groups (two launches); odd pixel heights
for the half-block families; layouts whose composite has background bars.
The sharded render (parallel/mesh.py): each shard's launch from
models/server.shard_launches, whose descriptors start at the shard's first
pixel row of the word map and write a record buffer of the shard's own,
over 1-D and 2-D meshes, gathered by MeshArena.fetch into the unsharded
layout against the plain render; and the multi-card bookkeeping on two
device keys of the CPU (a stack copy, an arena and launches per device).
It checks the kernel's logic (tiles, the group lookup, each thread's
cp.async copies of the tile's map words and the wait for them, the one
gather per tile into shared memory, the filters, the byte stores from
registers); the compiled kernel is checked on the card
(test_torch_kernels.py, chip_smoke.py). Tolerance: exact (uint8 records), and every byte of every
record is written (the arena starts as noise)."""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.models import server
from asciichat_tpu_torch.ops import cells, compositor, filters
from asciichat_tpu_torch.parallel import mesh as meshlib
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.runtime import kernel_build

TESTS = Path(__file__).resolve().parent
LAUNCH = r"render_groups_kernel<<<\(unsigned\)tiles, kThreads, 0, \(cudaStream_t\)stream>>>\("
CPU = torch.device("cpu")
SIZES = [(64, 48), (48, 64), (80, 60)]  # CONTAIN fits leave background bars
STACK = (3, 64, 80)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ac_render_groups built by g++ from csrc/render_group.cu with the CUDA
    grid emulated."""
    src = (kernel_build.CSRC_DIR / "render_group.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_pipeline.h>", "")
    src, n = re.subn(LAUNCH, "EMU_LAUNCH_GRID(render_groups_kernel, (int)tiles, kThreads, 0, ",
                     src)
    assert n == 1, "the kernel's launch line changed: update LAUNCH"
    out = tmp_path_factory.mktemp("emu")
    (out / "render_group_emu.cpp").write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{TESTS}", f"-I{kernel_build.CSRC_DIR}", "-o", str(out / "librg_emu.so"),
           str(out / "render_group_emu.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "librg_emu.so"))
    lib.ac_render_groups.argtypes = kernel_build.ENTRY_POINTS["ac_render_groups"]
    lib.ac_render_groups.restype = ctypes.c_int
    return lib


def _stack(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (*STACK, 3), dtype=np.uint8))


class Group:
    """One group of a case: a mode at (dst_h px, dst_w) from SIZES composed
    for a term_w x term_h terminal, its receivers' filters and palette."""

    def __init__(self, mode, dst_h, dst_w, names, palette=pal.DEFAULT_PALETTE,
                 term=(40, 12)):
        plan = compositor.plan_composite(SIZES, *term)
        arrays = dict(zip(server.MAP_NAMES, compositor.host_maps(plan)))
        self.maps = server.GroupMaps.from_host(arrays, dst_h, dst_w, CPU)
        self.mode, self.dst_h, self.dst_w, self.names = mode, dst_h, dst_w, names
        self.ramp = cells.ramp_for_palette(palette)

    def params(self, time_s):
        return filters.filter_params(self.names, time_s)

    def job(self, time_s) -> server.K3Job:
        return server.K3Job(self.maps, cells.mode_family(self.mode), self.dst_h, self.dst_w,
                            self.ramp.numpy(), server.receiver_words(*self.params(time_s)))

    def plain(self, frames, time_s):
        m = self.maps
        return server.render_compute(
            frames, self.ramp, *(torch.from_numpy(p) for p in self.params(time_s)),
            m.cidx, m.src_y, m.src_x, m.comp_mask, mode=self.mode, dst_h=self.dst_h,
            dst_w=self.dst_w)


def _check(lib, groups, sm_count, seed=0, time_s=1.3, launches=1):
    frames = _stack(seed)
    jobs = [g.job(time_s) for g in groups]
    arena = server.RecordArena(CPU)
    records = arena.layout([(j.family, len(j.receivers), j.hpx, j.width) for j in jobs])
    noise = np.random.default_rng(seed + 1)
    for rec in records:
        for t in rec.values():
            t.copy_(torch.from_numpy(noise.integers(0, 256, t.shape, dtype=np.uint8)))
    tables = server.k3_tables(frames, jobs, records, sm_count)
    assert len(tables) == launches
    for table in tables:
        assert lib.ac_render_groups(frames.data_ptr(), table.ctypes.data, len(table), None) == 0
    for i, (g, rec) in enumerate(zip(groups, records)):
        want = g.plain(frames, time_s)
        assert list(rec) == list(want)
        for k in want:
            assert torch.equal(rec[k], want[k]), f"group {i} ({g.mode}) {k}"


RECEIVERS = ["none", "green", "rainbow", "black"]


@pytest.mark.parametrize("mode", cells.MODES)
def test_emulated_family_matches_plain(emulated, mode):
    """One group per record family; half-block at an odd pixel height."""
    half = cells.mode_family(mode) in cells.HALFBLOCK_FAMILIES
    _check(emulated, [Group(mode, 23 if half else 11, 37, RECEIVERS, pal.BUILTIN_PALETTES["blocks"])],
           sm_count=16)


CASES = {  # built when a test runs, not when the module is imported
    "one": lambda: [Group("halfblock_truecolor", 21, 41, filters.FILTER_NAMES)],
    "two": lambda: [Group("256color", 9, 30, ["rainbow"], term=(30, 9)),
            Group("halfblock_16", 15, 25, ["cyan", "none", "rainbow", "pink", "black"])],
    "three": lambda: [Group("mono", 10, 33, ["red", "none"], pal.BUILTIN_PALETTES["digital"]),
              Group("halfblock_256", 21, 40, ["teal", "rainbow", "none", "white", "black",
                                               "orange", "magenta"], term=(40, 11)),
              Group("16color", 7, 19, ["yellow", "fuchsia", "none", "green"])],
}


@pytest.mark.parametrize("sm_count", [1, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_groups_match_plain(emulated, case, sm_count):
    """1-3 groups in one launch; sm_count 64 splits cell rows into tiles
    with a ragged last one, sm_count 1 keeps a row per tile."""
    groups = CASES[case]()
    _check(emulated, groups, sm_count, seed=len(groups))


def test_emulated_receivers_past_one_descriptor(emulated):
    names = (filters.FILTER_NAMES * 2)[:20]
    _check(emulated, [Group("halfblock_truecolor", 13, 26, names)], sm_count=8, seed=5)


def test_emulated_groups_past_one_launch(emulated):
    modes = list(cells.MODES) * 2
    groups = [Group(m, 5 + i % 4, 10 + 3 * i, [filters.FILTER_NAMES[i % 13]])
              for i, m in enumerate(modes[:18])]
    _check(emulated, groups, sm_count=4, seed=6, launches=2)


SHARD_CASES = {  # built when a test runs
    "odd_half": lambda: [Group("halfblock_truecolor", 23, 37, RECEIVERS),
                         Group("halfblock_16", 13, 25, ["cyan", "none", "rainbow", "pink", "black"],
                               term=(25, 7))],
    "families": lambda: [Group(m, 21 if cells.mode_family(m) in cells.HALFBLOCK_FAMILIES else 11,
                               19, ["none", "rainbow", "green"]) for m in cells.MODES],
    "wide": lambda: [Group("halfblock_256", 9, 26, (filters.FILTER_NAMES * 2)[:20])],
}
SHARD_MESHES = [(2, 1), (4, 1), (8, 1), (4, 2), (8, 2), (1, 3)]  # (clients, space)


@pytest.mark.parametrize("clients, space", SHARD_MESHES)
@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_emulated_row_shards_match_plain(emulated, case, clients, space):
    """One launch per shard (two descriptors for a shard that holds more
    than 16 receivers of a group), each shard's records in its own buffer,
    gathered into the unsharded layout: equal to the plain render of each
    group."""
    groups = SHARD_CASES[case]()
    frames = _stack(7)
    mesh = meshlib.make_mesh(clients * space, space, [CPU] * (clients * space))
    jobs = [g.job(1.3) for g in groups]
    arena = server.MeshArena(mesh)
    records, launches = server.shard_launches(
        {CPU: frames}, [(j, server.split_job(j, mesh)) for j in jobs], arena, lambda d: 8)
    noise = np.random.default_rng(8)
    for part in records:
        for _, rec in part.parts:
            for t in rec.values():
                t.copy_(torch.from_numpy(noise.integers(0, 256, t.shape, dtype=np.uint8)))
    shards = {shard.index for part in records for shard, _ in part.parts}
    assert len(launches) == len(shards)
    if case == "wide" and clients == 1:
        assert [len(table) for _, table in launches] == [2] * len(shards)
    for stack, table in launches:
        assert stack is frames
        assert lib_ok(emulated, frames, table)
    for i, (g, host) in enumerate(zip(groups, arena.fetch(records))):
        want = g.plain(frames, 1.3)
        assert sorted(host) == sorted(want)
        for k in want:
            assert np.array_equal(host[k], want[k].numpy()), f"group {i} ({g.mode}) {k}"


CPU0 = torch.device("cpu", 0)  # a second device key on the CPU


@pytest.mark.parametrize("clients, space", [(2, 1), (1, 2), (2, 2)])
def test_emulated_row_shards_on_distinct_devices(emulated, clients, space):
    """The host side of a mesh over several cards, with ``cpu`` and
    ``cpu:0`` taking turns over the grid in place of two cards: replicate
    gives the second device a copy of the stack, each device's parts are
    laid out in an arena of its own, each launch reads the stack of its
    shards' device and writes only into that device's arena, and the
    records that MeshArena.fetch gathers from both arenas equal the plain
    render of each group."""
    groups = SHARD_CASES["odd_half"]()
    frames = _stack(9)
    n = clients * space
    mesh = meshlib.make_mesh(n, space, [CPU, CPU0] * n)
    assert mesh.device_list() == [CPU, CPU0]
    stacks = meshlib.replicate(frames, mesh)
    assert list(stacks) == [CPU, CPU0] and stacks[CPU] is frames
    assert stacks[CPU0].data_ptr() != frames.data_ptr() and torch.equal(stacks[CPU0], frames)
    jobs = [g.job(1.3) for g in groups]
    arena = server.MeshArena(mesh)
    records, launches = server.shard_launches(
        stacks, [(j, server.split_job(j, mesh)) for j in jobs], arena, lambda d: 8)
    noise = np.random.default_rng(10)
    for part in records:
        for _, rec in part.parts:
            for t in rec.values():
                t.copy_(torch.from_numpy(noise.integers(0, 256, t.shape, dtype=np.uint8)))
    device_of = {id(t): d for d, t in stacks.items()}
    spans = {d: (a._dev.data_ptr(), a._dev.data_ptr() + a._dev.numel())
             for d, a in arena.arenas.items()}
    assert {device_of[id(stack)] for stack, _ in launches} == {CPU, CPU0}
    for stack, table in launches:
        lo, hi = spans[device_of[id(stack)]]
        outs = table[:, 1:4]
        assert ((outs == 0) | ((outs >= lo) & (outs < hi))).all()
        assert lib_ok(emulated, stack, table)
    for i, (g, host) in enumerate(zip(groups, arena.fetch(records))):
        want = g.plain(frames, 1.3)
        assert sorted(host) == sorted(want)
        for k in want:
            assert np.array_equal(host[k], want[k].numpy()), f"group {i} ({g.mode}) {k}"


def lib_ok(lib, frames, table) -> bool:
    return lib.ac_render_groups(frames.data_ptr(), table.ctypes.data, len(table), None) == 0


def test_host_limits_match_the_kernel():
    src = (kernel_build.CSRC_DIR / "render_group.cu").read_text()
    for name, value in (("kMaxGroups", server.K3_MAX_GROUPS),
                        ("kMaxReceivers", server.K3_MAX_RECEIVERS),
                        ("kMaxTileCells", server.K3_MAX_TILE_CELLS),
                        ("kDescWords", server.K3_DESC_WORDS)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
