#!/usr/bin/env python3
"""Where K4's time goes inside the kernel, on one card: thread 0's cycle
counter (clock64) at each stage of one or more builds of ``mixer.cu``.

    python3 tools/k4_stages.py NAME=PATH/mixer.cu [NAME=PATH/mixer.cu ...]

Each source is copied with a stamp at the kernel's entry, before each
numbered stage comment (``// 2.`` ... ``// 7.``; the windowed body of
``csrc/mixer.cu``), after the first copy starts and after the activity
vote, and before the final state write, and built with the port's nvcc
flags next to the header of this checkout's ``csrc/``. A source without the
numbered comments (a single-loop kernel) gets the entry and end stamps only.
For 4, 9 and 32 sources x 480 samples and x 4096 samples it prints each
build's device-only time per call (CUDA graph replay, the builds in turns
and again in reverse) and the median, over 30 calls, of each stamp's cycles
since entry (the last window's, where a tick spans several). Stamps cost a
few cycles each; the graph times are of the stamped builds. It also times
an empty one-CTA kernel, the floor of a launch. The clock rate and the card
are printed beside the numbers.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import k4_compare as kc  # noqa: E402
from asciichat_tpu_torch.ops import audio  # noqa: E402
from asciichat_tpu_torch.runtime import kernel_build  # noqa: E402

OUT = kernel_build.BUILD_DIR / "k4_stages"
END = 20  # the final stamp's slot
STAMPS = '''__device__ unsigned long long g_stamp[32];
namespace {
#define STAMP(i) do { if (threadIdx.x == 0) g_stamp[i] = clock64(); } while (0)
'''
EXTRA = '''
extern "C" int ac_stamps(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
__global__ void empty_kernel(float* out) {
  if (threadIdx.x == 0) out[0] = 1.0f;
}
extern "C" int ac_empty(float* out, void* stream) {
  empty_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(out);
  return cudaGetLastError();
}
'''


def stamped(src: str) -> str:
    """``src`` with the stamps in place (see the module's docstring)."""
    src = src.replace("namespace {\n", STAMPS, 1)
    src = src.replace("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n",
                      "  STAMP(0);\n  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n", 1)
    src = re.sub(r"^(    // ([2-7])\. )", lambda m: f"    STAMP({m.group(2)});\n{m.group(1)}",
                 src, flags=re.M)
    src = src.replace("  bool on = false;\n", "  STAMP(8);\n  bool on = false;\n", 1)
    src = src.replace("  if (!__syncthreads_or(on)) {",
                      "  const int vote = __syncthreads_or(on);\n  STAMP(9);\n  if (!vote) {", 1)
    for end in ("  if (t < sources) {\n    env_out[t] = env[t];",
                "  if (warp == 0) {\n    if (lane < sources) {\n      env_out"):
        if end in src:
            i = src.rindex(end)
            src = src[:i] + f"  STAMP({END});\n" + src[i:]
            break
    return src + EXTRA


def build(name: str, path: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(stamped(path.read_text()))
    cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, f"-I{kernel_build.CSRC_DIR}",
           "-o", str(lib), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"build of {src} failed:\n{r.stderr[-4000:]}")
    out = ctypes.CDLL(str(lib))
    out.ac_stamps.argtypes = [ctypes.c_void_p]
    out.ac_empty.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return out


def stamps(lib, call) -> dict[int, int]:
    """Median cycles since entry of each stamp over 30 calls."""
    runs = []
    for _ in range(30):
        call()
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * 32)()
        lib.ac_stamps(ctypes.addressof(raw))
        runs.append({i: raw[i] - raw[0] for i in range(1, 32) if raw[i]})
    return {i: int(statistics.median(r[i] for r in runs)) for i in sorted(runs[0])}


def main(argv: list[str]) -> int:
    if not argv or any("=" not in a for a in argv):
        print(__doc__, file=sys.stderr)
        return 2
    dev = cs.phase1_device()
    builds = {}
    for arg in argv:
        name, path = arg.split("=", 1)
        lib = build(name, Path(path).resolve())
        builds[name] = (lib, kc.entry(lib))
    consts = audio.mixer_consts(audio.MixerParams())
    flag = torch.zeros(1, device=dev)
    lib0 = next(iter(builds.values()))[0]
    # the stream is read at each call: graph capture runs on a stream of its own
    empty = cs.graph_ms(
        lambda: lib0.ac_empty(flag.data_ptr(), torch.cuda.current_stream().cuda_stream))
    clock = getattr(torch.cuda.get_device_properties(dev), "clock_rate", None)
    cs.say(f"empty one-CTA kernel: {empty * 1e3:.3f} us per launch (graph); "
           f"clock {clock} kHz [{cs.CARD}]")
    for n in (cs.AUDIO_N, 4096):
        for s in (4, 9, 32):
            samples, _ = cs.speech(1, s, n, 1)
            x = torch.from_numpy(samples[0]).to(dev)
            act = torch.ones(s, dtype=torch.bool, device=dev)
            state = audio.MixerState.init(s, s, dev).astuple()
            times: dict[str, list[float]] = {}
            for name in [*builds, *reversed(builds)]:
                fn = builds[name][1]
                times.setdefault(name, []).append(
                    cs.graph_ms(lambda fn=fn: kc.mix(fn, x, act, state, consts)) * 1e3)
            for name, (lib, fn) in builds.items():
                st = stamps(lib, lambda fn=fn: kc.mix(fn, x, act, state, consts))
                cs.say(f"  {s} x {n} {name}: device only {[round(v, 3) for v in times[name]]} us; "
                       f"cycles since entry {st} [{cs.CARD}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
