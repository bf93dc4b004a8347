#!/usr/bin/env python3
"""Time variants of the row-staging design of K1 and K2
(``tools/k12_staged/row_stage.cuh``, measured and not shipped) against each
other on one card.

    python3 tools/k12_variants.py [NAME ...]

Each variant is ``tools/k12_staged/row_stage.cuh`` with a few lines replaced
(``VARIANTS`` below; a replacement that no longer matches the source stops
the tool), built by nvcc with the port's flags, beside that directory's
``resize.cu``, ``cell_records.cu`` and ``records.cuh`` and the package's
``cells_math.cuh``, into a library of its own (all variants' nvcc runs at
once) and called through its ``ac_resize_nn`` and ``ac_cell_records`` with
the port's own tables (``ops/cells.cell_tables``).
For each variant and shape: K2's truecolor records and K1's pixels against
the plain version, bit for bit (the variants in ``TIMING_ONLY`` change the
output on purpose and are only timed), then the device time of one launch
warm (20 launches replayed from one CUDA graph) and cold (``chip_smoke.py``'s
``cold_ms``: each launch after an L2 flush that is timed apart and left
out), in turns: every variant once, then again in reverse order. The shapes
are chip_smoke's timed shapes (``timed_shapes``). The last line of standard
output is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from asciichat_tpu_torch.ops import cells, pixel  # noqa: E402
from asciichat_tpu_torch.render import palette  # noqa: E402
from asciichat_tpu_torch.runtime import kernel_build  # noqa: E402

STAGED = ROOT / "tools" / "k12_staged"
SOURCES = ("resize.cu", "cell_records.cu", "records.cuh", "row_stage.cuh")
OUT = ROOT / "build" / "k12_variants"


def const(name: str, old: int, new: int) -> tuple[str, str]:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


SKIP_EPILOGUE = ("      if (rel[i] < 0) continue;", "      if (rel[i] < 0 || cur.left > 0) continue;")
SKIP_STORES = ("      if (!Epi::bpc(o)) continue;", "      if (!Epi::bpc(o) || cur.left > 0) continue;")
ROW_COPY_BLOCK = """    const int g0 = first + head_part, g1 = last - tail_part;
    if (g1 >= g0) {
      bytes += 16 * (g1 - g0 + 1);
      if (lane == 0) {
        fence_proxy_async();
        bulk_copy_to_shared(dst + 16 * g0, a0 + 16 * g0, 16 * (g1 - g0 + 1), bar);
      }
    }"""
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "base": [],
    "stages_4": [const("kStages", 2, 4)],
    "stages_3": [const("kStages", 2, 3)],
    "stages_6": [const("kStages", 2, 6)],
    # a row as 16-byte cp.async copies spread over the lanes, in place of
    # one bulk copy
    "ldgsts_dense": [(ROW_COPY_BLOCK, """    const int g0 = first + head_part, g1 = last - tail_part;
    for (int g = g0 + lane; g <= g1; g += 32)
      __pipeline_memcpy_async(dst + 16 * g, a0 + 16 * g, 16);""")],
    # the staging alone: no epilogue, no record stores
    "copies_only": [SKIP_EPILOGUE, SKIP_STORES],
    # the epilogue and stores on whatever the stage holds: no copies
    "no_copies": [
        ("        bulk_copy_to_shared(dst + 16 * g0, a0 + 16 * g0, 16 * (g1 - g0 + 1), bar);", ""),
        ("  if (lane == 0) mbarrier_arrive_expect_tx(bar, bytes);",
         "  if (lane == 0) mbarrier_arrive_expect_tx(bar, 0);")],
    # the records written, but not stored
    "no_stores": [SKIP_STORES],
}
# clock64 spans of each warp's phases, summed over the warps (K1 only):
# read back through an entry point that the tool appends to resize.cu
VARIANTS["profile"] = [
    ("namespace ac {\n", "namespace ac {\nstatic __device__ unsigned long long g_prof[8];\n"),
    ("  int slot = 0, parity = 0;\n",
     "  long long pt[5] = {0, 0, 0, 0, 0}, pt0 = 0, ptop = 0;\n"
     "  const long long p_loop = clock64();\n  int slot = 0, parity = 0;\n"),
    ("  const int64_t worker = blockIdx.x;\n",
     "  const int64_t worker = blockIdx.x;\n  const long long p_begin = clock64();\n"),
    ("  while (cur.left > 0) {\n", "  while (cur.left > 0) {\n    ptop = clock64();\n"),
    ("    __pipeline_wait_prior(kStages - 1);\n    __syncwarp();",
     "    pt[4] += clock64() - ptop;\n    pt0 = clock64();\n"
     "    __pipeline_wait_prior(kStages - 1);\n    __syncwarp();"),
    ("    const uint8_t* stage[Epi::kRows];\n#pragma unroll\n    for (int row = 0; row < Epi::kRows; ++row)\n      stage[row]",
     "    pt[0] += clock64() - pt0;\n    pt0 = clock64();\n"
     "    const uint8_t* stage[Epi::kRows];\n#pragma unroll\n    for (int row = 0; row < Epi::kRows; ++row)\n      stage[row]"),
    ("    __syncwarp();\n    if (ahead.left > 0) {\n      produce<",
     "    __syncwarp();\n    pt[1] += clock64() - pt0;\n    pt0 = clock64();\n"
     "    if (ahead.left > 0) {\n      produce<"),
    ("    // the tile's records: ragged bytes at each end, 16-byte words between\n",
     "    pt[2] += clock64() - pt0;\n    pt0 = clock64();\n"
     "    // the tile's records: ragged bytes at each end, 16-byte words between\n"),
    ("    }\n    cursor_next(cur, k, epi.rows);\n",
     "    }\n    pt[3] += clock64() - pt0;\n    cursor_next(cur, k, epi.rows);\n"),
    ("      parity ^= 1;\n    }\n  }\n}\n",
     "      parity ^= 1;\n    }\n  }\n  if (lane == 0) {\n"
     "    for (int i = 0; i < 5; ++i) atomicAdd(&g_prof[i], (unsigned long long)pt[i]);\n"
     "    atomicAdd(&g_prof[5], (unsigned long long)(p_loop - p_begin));\n"
     "    atomicAdd(&g_prof[6], (unsigned long long)(clock64() - p_begin));\n"
     "    atomicAdd(&g_prof[7], 1ull);\n  }\n}\n"),
]
PROFILE_ENTRY = """
extern "C" int ac_prof(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return cudaMemcpyToSymbol(ac::g_prof, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(host, ac::g_prof, 8 * sizeof(unsigned long long));
}
"""
PROFILE_SPANS = ("wait", "compute", "produce", "stores", "top", "prologue", "kernel", "warps")
VARIANTS["profile_no_copies"] = VARIANTS["profile"] + VARIANTS["no_copies"]
TIMING_ONLY = {"copies_only", "no_copies", "no_stores", "profile", "profile_no_copies"}


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    jobs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in SOURCES:
            text = (STAGED / src).read_text()
            if src == "row_stage.cuh":
                for old, new in VARIANTS[name]:
                    if text.count(old) != 1:
                        raise SystemExit(f"variant {name}: {old!r} does not match row_stage.cuh")
                    text = text.replace(old, new)
            if src == "resize.cu" and name.startswith("profile"):
                text += PROFILE_ENTRY
            (d / src).write_text(text)
        jobs[name] = subprocess.Popen(
            [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, f"-I{d}",
             f"-I{kernel_build.CSRC_DIR}", "-o",
             str(d / "lib.so"), str(d / "resize.cu"), str(d / "cell_records.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        text = job.communicate()[0]
        if job.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{text[-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for entry in ("ac_resize_nn", "ac_cell_records"):
            fn = getattr(lib, entry)
            fn.argtypes = kernel_build.ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def calls(lib, f: torch.Tensor, dh: int, dw: int, ramp: torch.Tensor):
    """K1's and K2's (truecolor_fg) launches of ``lib`` at one shape."""
    b, h, w, _ = f.shape
    t = cells.cell_tables(h, w, dh, dw, f.device)

    def k1():
        out = torch.empty((b, dh, dw, 3), dtype=torch.uint8, device=f.device)
        rc = lib.ac_resize_nn(f.data_ptr(), b, h, w, t.resize.sy.data_ptr(), dh,
                              t.resize.sx.data_ptr(), dw, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def k2():
        recs = cells.allocate_records(cells.FAM_RGB_LUMA, b, dh, dw, f.device)
        rc = lib.ac_cell_records(cells.FAM_RGB_LUMA, f.data_ptr(), b, h, w,
                                 t.resize.sy.data_ptr(), dh, t.resize.sx.data_ptr(), dw,
                                 ramp.data_ptr(), *cells.record_pointers(recs),
                                 torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return recs
    return k1, k2


def profile(name: str, lib, k1) -> dict:
    """The profile variant's spans (clock64 cycles summed over the warps) of
    one K1 launch, and each span per warp."""
    fn = lib.ac_prof
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 8)()
    assert fn(buf, 1) == 0
    k1()
    torch.cuda.synchronize()
    assert fn(buf, 0) == 0
    spans = dict(zip(PROFILE_SPANS, list(buf)))
    warps = max(spans["warps"], 1)
    cs.say(f"  {name} K1: cycles a warp: " + ", ".join(
        f"{k} {spans[k] / warps:.0f}" for k in PROFILE_SPANS[:-1]) + f" over {warps} warps")
    return spans


def main(argv: list[str]) -> int:
    names = argv or list(VARIANTS)
    dev = cs.phase1_device()
    libs = build(names)
    frames = cs.make_frames(cs.BATCH, cs.SRC_H, cs.SRC_W, seed=2, device=dev)
    shapes = cs.timed_shapes(frames, cs.make_frames(cs.BATCH, cs.WEBCAM_H, cs.WEBCAM_W, seed=4,
                                                    device=dev),
                             cs.make_frames(cs.BATCH_4K, cs.SRC_4K_H, cs.SRC_4K_W, seed=3,
                                            device=dev))
    ramp = cells.ramp_for_palette(palette.DEFAULT_PALETTE)
    flush = cs.L2Flush(dev)
    report: dict = {"card": cs.CARD, "rates": cs.memory_rates(dev), "shapes": {}}
    for label, (f, dh, dw) in shapes.items():
        want1 = pixel.resize_nn(f, dh, dw)
        want2 = cs.plain_cells(f, ramp, dh, dw, "truecolor_fg")
        fns = {}
        for name in names:
            k1, k2 = calls(libs[name], f, dh, dw, ramp)
            if name not in TIMING_ONLY:
                cs.check_exact(f"{name} K1 {label}", k1(), want1, [])
                cs.check_exact(f"{name} K2 {label}", k2(), want2, [])
            fns[name] = {"K1": k1, "K2": k2}
        times = {name: {"K1": [], "K2": []} for name in names}
        for order in (names, names[::-1]):
            for name in order:
                for kind in ("K1", "K2"):
                    fn = fns[name][kind]
                    times[name][kind].append({"warm": cs.graph_ms(fn),
                                              "cold": cs.cold_ms(fn, flush)[0]})
        for name in names:
            for kind in ("K1", "K2"):
                t = times[name][kind]
                cs.say(f"  {label:>12} {kind} {name:>12}: warm "
                       f"{cs.fmt([x['warm'] for x in t])} ms, cold "
                       f"{cs.fmt([x['cold'] for x in t])} ms [{cs.CARD}]")
        report["shapes"][label] = times
        for name in names:
            if name.startswith("profile"):
                report.setdefault(name, {})[label] = profile(name, libs[name], fns[name]["K1"])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
