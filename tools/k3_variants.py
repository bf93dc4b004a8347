#!/usr/bin/env python3
"""Time variants of K3 (``csrc/render_group.cu``) against each other on one
card.

    python3 tools/k3_variants.py

Each variant is this checkout's ``render_group.cu`` with a few lines
replaced (``VARIANTS`` below; a replacement that no longer matches the
source stops the tool), built by nvcc with the port's flags into its own
library and called through its ``ac_render_groups`` with descriptor tables
from ``models/server.k3_tables``, at a number of SMs that sets the tile
width (``tile_width``). For each variant and tiling: the records of
``chip_smoke.py`` phase 5's half-block truecolor group and of phase 5b's
three groups against the plain version (bit for bit; a variant that returns
early is only timed), and the device-only time of one launch (20 launches
replayed from one CUDA graph), in turns: every variant once, then again in
reverse order. Variants in ``TIMING_ONLY`` change the records on purpose
(an empty body, no filter, no second trip to memory) and are only timed.
The last line of standard output is one JSON object.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from asciichat_tpu_torch.models import server  # noqa: E402
from asciichat_tpu_torch.runtime import kernel_build  # noqa: E402

EMPTY = ("  int gi = 0;\n  while", "  if (p.groups > 0) return;\n  int gi = 0;\n  while")
# each map word loaded directly by the thread that gathers its pixel, in
# place of the cp.async staging
DIRECT_WORDS = [("""    __pipeline_memcpy_async(pix + pl * kMaxTileCells + x,
                            d.words + (int64_t)y * d.width + x0 + x, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  // 2. Each sampled pixel of the tile once, for every receiver, in place of
  //    its word.
  for (int q = t; q < kPlanes * n; q += kThreads) {
    const int i = q < n ? q : kMaxTileCells + q - n;
    pix[i] = gather(frames, (int32_t)pix[i]);
  }""", """    pix[pl * kMaxTileCells + x] =
        gather(frames, __ldg(d.words + (int64_t)y * d.width + x0 + x));
  }""")]
# the records staged in shared memory, each receiver's segment at its
# destination's 16-byte phase, then stored in 16-byte pieces (single bytes
# at the segment's ragged ends) after a second barrier
STAGED_STORES = [
    ("// One gathered pixel:", """constexpr int kSlotMax = (3 * kMaxTileCells + 30) & ~15;
__shared__ __align__(16) uint8_t stage[kMaxReceivers * 2 * kSlotMax];

// One gathered pixel:"""),
    ("  const int dc = kThreads / n,", """  int slot[kRecs], base[kRecs];
  for (int o = 0, off = 0; o < kRecs; ++o) {
    slot[o] = (n * record_bytes(FAM, o) + 30) & ~15;
    base[o] = off;
    off += d.receivers * slot[o];
  }
  const int dc = kThreads / n,"""),
    ("    for (int o = 0; o < kRecs; ++o) s[o] = out[o] + c * step[o] + x * record_bytes(FAM, o);",
     """    for (int o = 0; o < kRecs; ++o)
      s[o] = stage + base[o] + c * slot[o] + (int)((uintptr_t)(out[o] + c * step[o]) & 15) +
             x * record_bytes(FAM, o);"""),
    ("""      }
    }
  }
}

__global__""", """      }
    }
  }
  __syncthreads();
  for (int o = 0; o < kRecs; ++o) {
    const int len = n * record_bytes(FAM, o), pieces = len / 16 + 2;
    for (int q = t; q < d.receivers * pieces; q += kThreads) {
      const int c = q / pieces, m = q - c * pieces;
      uint8_t* g = out[o] + c * step[o];
      const int phase = (int)((uintptr_t)g & 15);
      const uint8_t* s = stage + base[o] + c * slot[o];
      const int lo = 16 * m - phase;
      if (lo >= len) continue;
      if (lo >= 0 && lo + 16 <= len) {
        *reinterpret_cast<uint4*>(g + lo) = *reinterpret_cast<const uint4*>(s + 16 * m);
      } else {
        for (int i = lo < 0 ? 0 : lo; i < imin(lo + 16, len); ++i) g[i] = s[phase + i];
      }
    }
  }
}

__global__"""),
]
# timing only (their records are not the plain version's): no filter, or
# the map word taken for the pixel (no second trip to memory)
NO_FILTER = [("""  ac::colorize(p.r, p.g, p.b, (int)(v >> 24), f.r, f.g, f.b,
               (f.flags & kFgOnBg) != 0, (f.flags & kRainbow) != 0,
               (f.flags & kEnabled) != 0);""", "  (void)f;")]
ONE_TRIP = [("""  const uint8_t* s = frames + word;
  const int r = __ldg(s), g = __ldg(s + 1), b = __ldg(s + 2);""",
             "  const int r = word & 255, g = word >> 8 & 255, b = word >> 16 & 255;")]
TIMING_ONLY = {"empty", "no_filter", "one_trip"}
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "base": [],
    "empty": [EMPTY],
    "no_filter": NO_FILTER,
    "one_trip": ONE_TRIP,
    "512_threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "128_threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "4_groups_param": [("constexpr int kMaxGroups = 16;", "constexpr int kMaxGroups = 4;")],
    "direct_words": DIRECT_WORDS,
    "staged_stores": STAGED_STORES,
}
SM_COUNTS = (132, 1, 264)  # tiles: about one per SM, a cell row each, about two per SM


def variant_source(name: str) -> str:
    src = (kernel_build.CSRC_DIR / "render_group.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:60]!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(name: str) -> ctypes.CDLL:
    src = variant_source(name)
    digest = hashlib.sha256(src.encode() + " ".join(kernel_build.NVCC_FLAGS).encode())
    out = kernel_build.BUILD_DIR / f"libk3-{name}-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        unit = out.with_suffix(".cu")
        unit.parent.mkdir(parents=True, exist_ok=True)
        unit.write_text(src)
        cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS,
               f"-I{kernel_build.CSRC_DIR}", "-o", str(out), str(unit)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    lib.ac_render_groups.argtypes = kernel_build.ENTRY_POINTS["ac_render_groups"]
    lib.ac_render_groups.restype = ctypes.c_int
    return lib


def main() -> int:
    dev = cs.phase1_device()
    stack = cs.make_frames(cs.SERVER_SOURCES, cs.UPLINK_H, cs.UPLINK_W, seed=5, device=dev)
    sizes = [(cs.UPLINK_W, cs.UPLINK_H)] * cs.SERVER_SOURCES
    cases = {"phase5": [cs.THREE_GROUPS[0]], "three_groups": cs.THREE_GROUPS}
    libs = {name: build(name) for name in VARIANTS}
    setups = {}
    for case, spec in cases.items():
        groups = [server.RenderGroup(sizes, w, h, caps, names, device=dev)
                  for w, h, caps, names in spec]
        server.render_groups(stack, groups, 1.25)  # the rainbow tint at 1.25 s
        want = [cs.plain_group(g, stack) for g in groups]
        arena = server.RecordArena(dev)
        records = arena.layout([(j.family, len(j.receivers), j.hpx, j.width)
                                for j in (g.job for g in groups)])
        for sm in SM_COUNTS:
            tables = server.k3_tables(stack, [g.job for g in groups], records, sm)
            # the groups too: the tables point into their word maps
            setups[(case, sm)] = (tables, records, want, groups)
    times: dict[str, dict[str, list[float]]] = {}
    exact: dict[str, bool] = {}
    order = list(VARIANTS)
    for name in order + order[::-1]:
        lib = libs[name]
        for (case, sm), (tables, records, want, _) in setups.items():

            def launch(lib=lib, tables=tables):
                stream = torch.cuda.current_stream().cuda_stream
                for table in tables:
                    rc = lib.ac_render_groups(stack.data_ptr(), table.ctypes.data,
                                              len(table), stream)
                    if rc:
                        raise RuntimeError(f"ac_render_groups: CUDA error {rc}")

            for rec in records:
                for t in rec.values():
                    t.fill_(0x5A)
            cs.say(f"  run {name} {case} sm={sm}")  # names the launch a fault stops
            launch()
            torch.cuda.synchronize()
            if name not in TIMING_ONLY:
                ok = all(cs.max_abs_err(r, w) == 0 for r, w in zip(records, want))
                exact[name] = exact.get(name, True) and ok
            key = f"{case} sm={sm} tiles={tiles(tables)}"
            times.setdefault(name, {}).setdefault(key, []).append(cs.graph_ms(launch))
    for name in order:
        for key, values in times[name].items():
            cs.say(f"  time {name:15s} {key}: {', '.join(f'{v * 1e3:.3f}' for v in values)} us "
                   f"(median {statistics.median(values) * 1e3:.3f}) [{cs.CARD}]")
        cs.say(f"  bits {name}: {'exact' if exact.get(name, True) else 'DIFFERENT'}")
    cs.say(json.dumps({"card": cs.CARD, "exact": exact, "times_ms": times}))
    return 0 if all(exact.values()) else 1


def tiles(tables) -> int:
    """CTAs of one launch over ``tables`` (the kernel's own count)."""
    total = 0
    for table in tables:
        for row in table:
            hpx, width, tile_w, family = (int(v) for v in row[4:8])
            rows = (hpx + 1) // 2 if family in server.cells.HALFBLOCK_FAMILIES else hpx
            total += rows * -(-width // tile_w)
    return total


if __name__ == "__main__":
    sys.exit(main())
