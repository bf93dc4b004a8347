#!/usr/bin/env python3
"""Hold two builds of K4 (``csrc/mixer.cu``) against each other on one card.

    python3 tools/k4_compare.py OLD_CSRC_DIR

``OLD_CSRC_DIR`` holds another version's ``mixer.cu`` and ``mixer_math.cuh``
(for example ``asciichat_tpu_torch/csrc`` of an earlier commit, unpacked
with ``git archive`` into ``build/``). The other build is this checkout's
``csrc/mixer.cu``, built as the port builds it. Both are called through the
same ctypes path with the same arguments, so only the kernel differs.

1. Bit for bit: ``chip_smoke.py`` phase 9's input (200 carried ticks of 9
   sources x 480 samples: bursts, dropped sources, one all-silent tick), each
   build carrying its own state; every mix and every state value must be
   equal, else the first element that differs is printed and the exit code
   is 1.
2. Time per tick, in turns old, new, new, old, at 4, 9 and 32 sources x 480
   samples: device only (20 calls replayed from one CUDA graph) and eager
   (CUDA events around back-to-back calls), with the card's name and power
   limit.

The last line of standard output is one JSON object with the results.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from asciichat_tpu_torch.ops import audio  # noqa: E402
from asciichat_tpu_torch.runtime import kernel_build  # noqa: E402

TICKS = 200  # chip_smoke.MIXER_TICKS
TIMED_SOURCES = (4, 9, 32)  # the live server's 4 clients, phase 9's 9, MAX_CLIENTS


def build_other(csrc: Path) -> ctypes.CDLL:
    """``csrc/mixer.cu`` alone, with the port's nvcc flags, into build/."""
    src = csrc / "mixer.cu"
    digest = hashlib.sha256(src.read_bytes() + (csrc / "mixer_math.cuh").read_bytes())
    out = kernel_build.BUILD_DIR / f"libmixer-other-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, f"-I{csrc}",
               "-o", str(out), str(src)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"build of {src} failed:\n{r.stderr[-4000:]}")
    return ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL):
    fn = lib.ac_mixer
    fn.argtypes = kernel_build.ENTRY_POINTS["ac_mixer"]
    fn.restype = ctypes.c_int
    return fn


def mix(fn, x: torch.Tensor, act: torch.Tensor, state: tuple, consts: np.ndarray):
    """One exclude-self tick through ``fn`` (an ``ac_mixer``)."""
    s, n = x.shape
    out = torch.empty((s, n), dtype=torch.float32, device=x.device)
    new = tuple(torch.empty_like(t) for t in state)
    rc = fn(x.data_ptr(), act.data_ptr(), s, n, *(t.data_ptr() for t in state), 1,
            consts.ctypes.data, out.data_ptr(), *(t.data_ptr() for t in new),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ac_mixer: CUDA error {rc}")
    return out, new


def first_difference(a: torch.Tensor, b: torch.Tensor):
    """(index, a value, b value) of the first element whose bits differ."""
    ia, ib = a.view(torch.int32), b.view(torch.int32)
    idx = torch.nonzero(ia != ib)
    if not len(idx):
        return None
    i = tuple(int(v) for v in idx[0])
    return i, float(a[i]), float(b[i])


def bit_check(dev, old, new, consts) -> dict:
    s = cs.SERVER_SOURCES
    samples, active = cs.speech(9, s, cs.AUDIO_N, TICKS)  # phase 9's input
    st_old = st_new = audio.MixerState.init(s, s, dev).astuple()
    compared = 0
    for t in range(TICKS):
        x = torch.from_numpy(samples[t]).to(dev)
        act = torch.from_numpy(active[t]).to(dev)
        o_old, st_old = mix(old, x, act, st_old, consts)
        o_new, st_new = mix(new, x, act, st_new, consts)
        torch.cuda.synchronize()
        for name, a, b in [("mixes", o_old, o_new),
                           *zip(("envelope", "duck_gain", "comp_envelope", "comp_gain"),
                                st_old, st_new)]:
            diff = first_difference(a, b)
            compared += a.numel()
            if diff is not None:
                return {"identical": False, "tick": t, "tensor": name, "index": diff[0],
                        "old": diff[1], "new": diff[2], "compared": compared}
    return {"identical": True, "ticks": TICKS, "compared": compared}


def timings(dev, old, new, consts) -> dict:
    out = {}
    for s in TIMED_SOURCES:
        samples, active = cs.speech(1, s, cs.AUDIO_N, 1)
        x = torch.from_numpy(samples[0]).to(dev)
        act = torch.ones(s, dtype=torch.bool, device=dev)
        state = audio.MixerState.init(s, s, dev).astuple()
        turns = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            fn = old if name == "old" else new
            call = lambda fn=fn: mix(fn, x, act, state, consts)  # noqa: E731
            turns[name].append({"device_ms": cs.graph_ms(call),
                                "eager_ms": cs.cuda_ms(call, iters=50)})
        out[f"{s}x{cs.AUDIO_N}"] = turns
        for name, runs in turns.items():
            dev_ms = [r["device_ms"] for r in runs]
            eager = [r["eager_ms"] for r in runs]
            cs.say(f"  time {name} K4 {s} x {cs.AUDIO_N}: device only "
                   f"{', '.join(f'{v:.5f}' for v in dev_ms)} ms (median "
                   f"{statistics.median(dev_ms):.5f}), eager "
                   f"{', '.join(f'{v:.4f}' for v in eager)} ms [{cs.CARD}]")
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    dev = cs.phase1_device()
    old = entry(build_other(Path(argv[0]).resolve()))
    new = entry(kernel_build.cuda_lib())
    consts = audio.mixer_consts(audio.MixerParams())
    cs.say(f"K4 old ({argv[0]}) vs new (this checkout), {TICKS} carried ticks at "
           f"{cs.SERVER_SOURCES} x {cs.AUDIO_N}")
    bits = bit_check(dev, old, new, consts)
    cs.say(f"  bits: {json.dumps(bits)}")
    times = timings(dev, old, new, consts)
    cs.say(json.dumps({"card": cs.CARD, "bits": bits, "times": times}))
    return 0 if bits["identical"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
