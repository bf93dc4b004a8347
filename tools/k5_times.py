#!/usr/bin/env python3
"""Time K5 (``csrc/capture.cu``, the client's capture chain) on one card,
stage by stage, and optionally against another version of it.

    python3 tools/k5_times.py [OTHER_CSRC_DIR]

Each line times one launch shape: device only (20 calls replayed from one
CUDA graph) and eager (CUDA events around back-to-back calls), at 256 taps x
480 samples (the client's chain), at 32 taps (one weight a lane: what is
left is the per-sample chain of the NLMS step), at 1024 taps, without the
AEC (highpass and gate alone) and at 48 samples, then
``ClientAudioPipeline.process`` per 480-sample frame on the host clock (copy
in, launch, copy out, event wait), with the card's name and power limit.

With ``OTHER_CSRC_DIR`` (another version's ``capture.cu``, e.g. an earlier
commit's ``asciichat_tpu_torch/csrc`` unpacked with ``git archive`` under
``build/``), both builds run chip_smoke.py phase 12's 300 carried frames at
256 x 480, each carrying its own state, and the largest difference of their
outputs and weights is printed; then each shape is timed in turns other,
this, this, other. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from asciichat_tpu_torch.ops import audio  # noqa: E402
from asciichat_tpu_torch.runtime import kernel_build  # noqa: E402

ALL = audio.STAGE_AEC | audio.STAGE_HIGHPASS | audio.STAGE_GATE
SHAPES = [  # (label, taps, n, stages)
    ("256 taps x 480", 256, 480, ALL),
    ("32 taps x 480", 32, 480, ALL),
    ("1024 taps x 480", 1024, 480, ALL),
    ("no AEC x 480", 0, 480, audio.STAGE_HIGHPASS | audio.STAGE_GATE),
    ("256 taps x 48", 256, 48, ALL),
]


def build_other(csrc: Path) -> ctypes.CDLL:
    """``capture.cu`` of ``csrc`` alone, with the port's nvcc flags, into build/."""
    src = csrc / "capture.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = kernel_build.BUILD_DIR / f"libcapture-other-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(out),
               str(src)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"build of {src} failed:\n{r.stderr[-4000:]}")
    return ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL):
    fn = lib.ac_capture_chain
    fn.argtypes = kernel_build.ENTRY_POINTS["ac_capture_chain"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, stages: int, taps: int, mic, far, state, buf):
    """A call of ``fn`` (an ``ac_capture_chain``) that updates ``state`` in
    place, as ClientAudioPipeline launches it."""
    n = mic.shape[0]
    consts = audio.capture_consts(n, mu=0.5, geigel_t=0.5, hp_alpha=audio.highpass_alpha(100.0),
                                  gate_threshold=0.01)
    ptrs = [t.data_ptr() for t in state]

    def call():
        rc = fn(mic.data_ptr(), far.data_ptr(), n, taps, stages, 1440, *ptrs,
                consts.ctypes.data, buf.data_ptr(), *ptrs,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ac_capture_chain: CUDA error {rc}")
    return call


def time_shape(dev, fn, taps: int, n: int, stages: int) -> dict:
    mic, far = (torch.from_numpy(a[0]).to(dev) for a in cs.capture_scenario(3, 1, n))
    state = cs.capture_state(taps, dev)
    call = launcher(fn, stages, taps, mic, far, state, torch.empty(n + 3, device=dev))
    return {"device_ms": cs.graph_ms(call), "eager_ms": cs.cuda_ms(call, iters=50)}


def carried(dev, fn, mic: np.ndarray, far: np.ndarray) -> tuple[list, list]:
    """Outputs and weights of ``fn`` over the frames, the state carried and
    halved as divergence control halves it."""
    state = cs.capture_state(256, dev)
    buf = torch.empty(mic.shape[1] + 3, device=dev)
    outs, weights = [], []
    for m, f in zip(mic, far):
        m, f = torch.from_numpy(m).to(dev), torch.from_numpy(f).to(dev)
        launcher(fn, ALL, 256, m, f, state, buf)()
        n = m.shape[0]
        outs.append(buf[:n].cpu())
        weights.append(state[0].cpu())
        _, out_e, mic_e = buf[n:n + 3].tolist()
        if out_e > 2.0 * mic_e + 1e-9:
            state[0].mul_(0.5)
    return outs, weights


def pipeline_ms(dev, frames: int = 300) -> list[float]:
    p = audio.ClientAudioPipeline(device=dev)
    mic, far = cs.capture_scenario(5, frames, cs.AUDIO_N)
    times = []
    for m, f in zip(mic, far):
        p.add_far(f)
        t0 = time.perf_counter()
        p.process(m)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[10:])


def main(argv: list[str]) -> int:
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    dev = cs.phase1_device()
    this = entry(kernel_build.cuda_lib())
    builds = {"this": this}
    result: dict = {"card": cs.CARD}
    if argv:
        builds["other"] = entry(build_other(Path(argv[0]).resolve()))
        mic, far = cs.capture_scenario(12, cs.CAPTURE_FRAMES, cs.AUDIO_N)
        o_out, o_w = carried(dev, builds["other"], mic, far)
        t_out, t_w = carried(dev, this, mic, far)
        diff = {"out": max(float((a - b).abs().max()) for a, b in zip(o_out, t_out)),
                "weights": max(float((a - b).abs().max()) for a, b in zip(o_w, t_w))}
        cs.say(f"other ({argv[0]}) vs this over {cs.CAPTURE_FRAMES} carried frames: "
               f"max |diff| {json.dumps(diff)}")
        result["diff"] = diff
    order = ("other", "this", "this", "other") if argv else ("this",)
    times: dict = {}
    for label, taps, n, stages in SHAPES:
        runs: dict = {name: [] for name in builds}
        for name in order:
            runs[name].append(time_shape(dev, builds[name], taps, n, stages))
        times[label] = runs
        for name, rs in runs.items():
            d = [r["device_ms"] for r in rs]
            cs.say(f"  time {name} K5 {label}: device only "
                   f"{', '.join(f'{v:.5f}' for v in d)} ms (median {statistics.median(d):.5f}), "
                   f"eager {', '.join(f'{r['eager_ms']:.4f}' for r in rs)} ms [{cs.CARD}]")
    pm = pipeline_ms(dev)
    cs.say(f"  time ClientAudioPipeline.process, {len(pm)} frames of 256 x 480 (host clock): "
           f"p50 {pm[len(pm) // 2]:.4f} ms, p99 {pm[int(len(pm) * 0.99)]:.4f} ms [{cs.CARD}]")
    result.update(times=times, pipeline_p50_ms=pm[len(pm) // 2],
                  pipeline_p99_ms=pm[int(len(pm) * 0.99)])
    cs.say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
