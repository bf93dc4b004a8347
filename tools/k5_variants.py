#!/usr/bin/env python3
"""Time variants of K5 (``csrc/capture.cu``) against each other on one card,
to see where a frame's time goes.

    python3 tools/k5_variants.py

Each variant is this checkout's ``capture.cu`` with a few lines replaced
(``VARIANTS`` below; a replacement that no longer matches the source stops
the tool), built by nvcc with the port's flags into its own library
(``tools/k5_times.build_other``), all builds at once. ``block16`` computes
the same function with the look-ahead in blocks of 16 samples. Each of
``REMOVALS`` leaves out one part of the kernel and computes wrong values on
purpose: it is only timed, and its difference from ``base`` is that part's
share of the time on the chain. Each is timed device only (20 launches replayed from one CUDA graph) at 256
and 32 taps x 480 samples and without the AEC, in turns: every variant
once, then again in reverse order. The last line of standard output is one
JSON object.
"""

from __future__ import annotations

import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import k5_times  # noqa: E402
from asciichat_tpu_torch.runtime import kernel_build  # noqa: E402

NO_GRAM = [("  const float* x0 = hist + s + 1;\n  float acc[kLags], run[kLags];",
            "  if (nb > 0) return;\n  const float* x0 = hist + s + 1;\n  float acc[kLags], run[kLags];")]
NO_SERIAL = [("        if (k >= nb) break;\n        const float e = sub(m, acc);",
              "        if (k >= 0) break;\n        const float e = sub(m, acc);")]
NO_UPDATE = [("        if (k < nb) w[u] = add(w[u], step[k]);",
              "        if (k < 0) w[u] = add(w[u], step[k]);")]
NO_MATVEC = [("        for (int k = 0; k < KW; ++k) acc = fused(w0[k], win[lane + kLanes * k], acc);",
              "        for (int k = 0; k < 0; ++k) acc = fused(w0[k], win[lane + kLanes * k], acc);")]
NO_LANES = [("      if (b > 0) highpass_block(s - kBlock, kBlock);\n    } else if (env_lane) {\n"
             "      gate_env_run(s, s + nb, fixed_target);\n",
             "      if (b < 0) highpass_block(s - kBlock, kBlock);\n    } else if (env_lane) {\n"
             "      gate_env_run(s, s, fixed_target);\n")]
NO_PROLOGUE = [("    for (int i = t; i < n; i += kThreads) {\n      const float* win = hist + i + 1;",
                "    for (int i = t; i < 0; i += kThreads) {\n      const float* win = hist + i + 1;")]
# another way of computing the same function: the look-ahead in blocks of 16
BLOCK16 = [("constexpr int kBlock = 32;", "constexpr int kBlock = 16;")]
REMOVALS = {
    "no_gram": NO_GRAM,
    "no_serial": NO_SERIAL,
    "no_update": NO_UPDATE,
    "no_matvec": NO_MATVEC,
    "no_lanes": NO_LANES,
    "no_prologue": NO_PROLOGUE,
    "loop_only": NO_GRAM + NO_SERIAL + NO_UPDATE + NO_MATVEC + NO_LANES + NO_PROLOGUE,
}
VARIANTS = {"base": [], "block16": BLOCK16, **REMOVALS}
SHAPES = [shape for shape in k5_times.SHAPES if shape[0] in
          ("256 taps x 480", "32 taps x 480", "no AEC x 480")]


def variant_source(name: str, patches: list[tuple[str, str]]) -> Path:
    src = (kernel_build.CSRC_DIR / "capture.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old[:60]!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    out = kernel_build.BUILD_DIR / "k5_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "capture.cu").write_text(src)
    return out


def main(argv: list[str]) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    dev = cs.phase1_device()
    dirs = [variant_source(name, patches) for name, patches in VARIANTS.items()]
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = list(pool.map(k5_times.build_other, dirs))
    fns = {name: k5_times.entry(lib) for name, lib in zip(VARIANTS, libs)}
    times: dict = {name: {label: [] for label, *_ in SHAPES} for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            for label, taps, n, mask in SHAPES:
                times[name][label].append(
                    k5_times.time_shape(dev, fns[name], taps, n, mask)["device_ms"])
    for name, by_shape in times.items():
        cs.say(f"  time K5 {name}: " + ", ".join(
            f"{label} {statistics.median(v) * 1e3:.2f} us" for label, v in by_shape.items())
            + f" [{cs.CARD}]")
    cs.say(json.dumps({"card": cs.CARD, "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
