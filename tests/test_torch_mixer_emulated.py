"""K4's source (csrc/mixer.cu) run on the CPU under an emulation of the CUDA
block (tests/cuda_emu.h: threads, barriers, warp shuffles, dynamic shared
memory, cp.async batches that land only when waited for), against the plain
mixer_process_reference: 20 ticks with the state carried, levels changing
from frame to frame, sources dropping out and one all-silent tick, at 1 to
32 sources, tick lengths from one sample to 16 frames (4096 samples at 32
sources spans several windows, so the next window loads while one is
computed), 16-byte and 4-byte copies (n % 4), with and without
exclude-self. It checks the kernel's logic (windows, the copy pipeline,
barriers, reductions, both scans, the silent-tick freeze) on every CPU test
run; the compiled kernel is checked on the card (test_torch_kernels.py,
chip_smoke.py). Tolerance rtol=2e-4, atol=2e-5, the bound
tests/test_audio.py holds the JAX mixer to; the all-silent tick is exact."""

import ctypes
import importlib.util
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.ops import audio
from asciichat_tpu_torch.runtime import kernel_build

TESTS = Path(__file__).resolve().parent
LAUNCH = r"kernel<<<1, kThreads, smem, \(cudaStream_t\)stream>>>\("
DYNAMIC_SMEM = r"extern __shared__ __align__\(16\) float smem\[\];"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ac_mixer built by g++ from csrc/mixer.cu with the CUDA block emulated."""
    src = (kernel_build.CSRC_DIR / "mixer.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_pipeline.h>", "")
    src, n = re.subn(LAUNCH, "EMU_LAUNCH(kernel, kThreads, smem, ", src)
    assert n == 1, "the kernel's launch line changed: update LAUNCH"
    src, n = re.subn(DYNAMIC_SMEM, "float* const smem = static_cast<float*>(emu_dynamic_smem);",
                     src)
    assert n == 1, "the kernel's dynamic shared memory changed: update DYNAMIC_SMEM"
    out = tmp_path_factory.mktemp("emu")
    (out / "mixer_emu.cpp").write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{TESTS}",
           f"-I{kernel_build.CSRC_DIR}", "-o", str(out / "libmixer_emu.so"),
           str(out / "mixer_emu.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "libmixer_emu.so"))
    lib.ac_mixer.argtypes = kernel_build.ENTRY_POINTS["ac_mixer"]
    lib.ac_mixer.restype = ctypes.c_int
    return lib


def _launch(lib, x: np.ndarray, act: np.ndarray, state: list, exclude_self: bool):
    s, n = x.shape
    out = np.empty((s if exclude_self else 1, n), np.float32)
    new = [np.empty_like(a) for a in state]
    consts = audio.mixer_consts(audio.MixerParams())
    rc = lib.ac_mixer(x.ctypes.data, act.ctypes.data, s, n,
                      *(a.ctypes.data for a in state), int(exclude_self),
                      consts.ctypes.data, out.ctypes.data,
                      *(a.ctypes.data for a in new), None)
    assert rc == 0
    return out, new


SHAPES = [(s, n) for s in (1, 2, 9, 32) for n in (1, 255, 256, 257, 480, 4096)]


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("s,n", SHAPES + [(9, 1000), (3, 0)])
def test_emulated_kernel_matches_plain(emulated, s, n, exclude_self):
    rng = np.random.default_rng(s * 10000 + n)
    c = s if exclude_self else 1
    plain = audio.MixerState.init(s, c).astuple()
    state = [t.numpy().copy() for t in plain]
    for tick in range(20):
        # a level per source and 256-sample frame, so the order in which a
        # scan takes the frames shows in the result
        level = rng.choice([0.0, 0.01, 0.1, 0.5, 1.5], (s, n // 256 + 1))
        x = (rng.standard_normal((s, n)) * np.repeat(level, 256, axis=1)[:, :n])
        x = x.astype(np.float32)
        act = rng.random(s) < 0.8
        if tick == 7:
            act[:] = False
        got, new = _launch(emulated, x, act, state, exclude_self)
        want, plain = audio.mixer_process_reference(torch.from_numpy(x), torch.from_numpy(act),
                                                     plain, exclude_self=exclude_self)
        np.testing.assert_allclose(got, want.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"tick {tick}")
        for a, b in zip(new, plain):
            np.testing.assert_allclose(a, b.numpy(), rtol=2e-4, atol=2e-5, err_msg=f"tick {tick}")
        if tick == 7:
            assert not got.any()
            assert all(np.array_equal(a, b) for a, b in zip(new, state))
        state = new


def test_stage_tool_stamps_every_stage():
    """tools/k4_stages.py finds each stage of csrc/mixer.cu by its numbered
    comment: a renamed stage would silently drop out of its breakdown."""
    spec = importlib.util.spec_from_file_location("k4_stages", TESTS.parent / "tools" / "k4_stages.py")
    stages = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stages)
    src = stages.stamped((kernel_build.CSRC_DIR / "mixer.cu").read_text())
    found = sorted(int(i) for i in re.findall(r"STAMP\((\d+)\);", src))
    assert found == [0, 2, 3, 4, 5, 6, 7, 8, 9, stages.END]
