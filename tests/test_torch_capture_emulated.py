"""K5's source (csrc/capture.cu) run on the CPU under an emulation of the CUDA
warp (tests/cuda_emu.h: 32 threads, warp shuffles, __syncwarp, dynamic shared
memory that starts as NaNs), against the plain capture_chain_reference of
ops/audio.py, with the state carried from frame to frame as the client
carries it (divergence control halves the weights between frames on each
side, from its own stats).

At one tap the NLMS dot products are single products, so the whole chain
must agree bit for bit: output, weights, far tail, hangover, filters, gate
and the frozen fraction (the energies are sums over the frame, in another
order). At 64 and 256 taps the output and weights agree within rtol=2e-4,
atol=2e-5 (the dot products sum lane by lane, then across the warp), the
far tail, hangover and frozen fraction exactly. Without the AEC the chain is
bit for bit the plain version's. Frames are of 1 to 480 samples, shorter and
longer than the taps; each stage also runs alone, and in place (the new
state over the old). It checks the kernel's logic on every CPU test run; the
compiled kernel is checked on the card (test_torch_kernels.py,
chip_smoke.py)."""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.ops import audio
from asciichat_tpu_torch.runtime import kernel_build

TESTS = Path(__file__).resolve().parent
LAUNCH = r"kernel<<<1, kLanes, smem, \(cudaStream_t\)stream>>>\("
DYNAMIC_SMEM = r"extern __shared__ float smem\[\];"
TOL = dict(rtol=2e-4, atol=2e-5)
SR = audio.SAMPLE_RATE
ALPHA = audio.highpass_alpha(100.0)
ALL = audio.STAGE_AEC | audio.STAGE_HIGHPASS | audio.STAGE_GATE
# the stage that owns each entry of the state, in fresh_state's order
STAGE_OF = (audio.STAGE_AEC,) * 3 + (audio.STAGE_HIGHPASS,) * 2 + (audio.STAGE_GATE,) * 2


def build_emulated(source: str, out_dir: Path) -> ctypes.CDLL:
    """ac_capture_chain built by g++ from ``source`` (csrc/capture.cu's text)
    with the CUDA warp emulated."""
    src = source.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, n = re.subn(LAUNCH, "EMU_LAUNCH(kernel, kLanes, smem, ", src)
    assert n == 1, "the kernel's launch line changed: update LAUNCH"
    src, n = re.subn(DYNAMIC_SMEM, "float* const smem = static_cast<float*>(emu_dynamic_smem);",
                     src)
    assert n == 1, "the kernel's dynamic shared memory changed: update DYNAMIC_SMEM"
    # the kernel's quotient, for test_quotient_is_the_ieee_division
    src += ("\nextern \"C\" void emu_quot(const float* a, const float* b, float* out, long n) {\n"
            "  for (long i = 0; i < n; ++i) out[i] = quot_by(a[i], b[i], quot(1.0f, b[i]));\n}\n")
    (out_dir / "capture_emu.cpp").write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{TESTS}",
           f"-I{kernel_build.CSRC_DIR}", "-o", str(out_dir / "libcapture_emu.so"),
           str(out_dir / "capture_emu.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out_dir / "libcapture_emu.so"))
    lib.ac_capture_chain.argtypes = kernel_build.ENTRY_POINTS["ac_capture_chain"]
    lib.ac_capture_chain.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulated((kernel_build.CSRC_DIR / "capture.cu").read_text(),
                          tmp_path_factory.mktemp("emu"))


def fresh_state(taps: int) -> dict:
    """The chain's state as numpy arrays, in K5's argument order."""
    return {"weights": np.zeros(taps, np.float32), "far_tail": np.zeros(taps, np.float32),
            "hang": np.zeros(1, np.int32), "hp_in": np.zeros(1, np.float32),
            "hp_out": np.zeros(1, np.float32), "gate_env": np.zeros(1, np.float32),
            "gate_open": np.zeros(1, np.uint8)}


def emu_frame(lib, stages, mic, far, state: dict, taps: int, in_place: bool = False):
    """One emulated K5 launch -> (out [n], stats [3], new state)."""
    n = len(mic)
    consts = audio.capture_consts(n, mu=0.5, geigel_t=0.5, hp_alpha=ALPHA,
                                  gate_threshold=0.01)
    buf = np.full(n + 3, np.nan, np.float32)
    # a stage that does not run leaves its state as it was
    new = state if in_place else {
        k: np.full_like(v, 7) if stages & stage else v.copy()
        for (k, v), stage in zip(state.items(), STAGE_OF)}
    mic = np.ascontiguousarray(mic, np.float32)
    far = np.ascontiguousarray(far, np.float32)
    rc = lib.ac_capture_chain(mic.ctypes.data, far.ctypes.data, n, taps, stages, 1440,
                              *(a.ctypes.data for a in state.values()), consts.ctypes.data,
                              buf.ctypes.data, *(a.ctypes.data for a in new.values()), None)
    assert rc == 0
    return buf[:n], buf[n:], new


def plain_frame(stages, mic, far, state: dict, taps: int):
    """The plain version of the same stages -> (out, stats, new state)."""
    t = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    t["hang"], t["gate_open"] = t["hang"][0], t["gate_open"][0].bool()
    for k in ("hp_in", "hp_out", "gate_env"):
        t[k] = t[k][0]
    x, stats = torch.from_numpy(np.asarray(mic, np.float32)), torch.zeros(3)
    if stages & audio.STAGE_AEC:
        x, t["weights"], t["far_tail"], t["hang"], stats = audio.echo_cancel_reference(
            x, torch.from_numpy(np.asarray(far, np.float32)), t["weights"], t["far_tail"],
            t["hang"], taps=taps)
    if stages & audio.STAGE_HIGHPASS:
        x, t["hp_in"], t["hp_out"] = audio.highpass_reference(x, t["hp_in"], t["hp_out"], ALPHA)
    if stages & audio.STAGE_GATE:
        x, t["gate_env"], t["gate_open"] = audio.noise_gate_reference(
            x, t["gate_env"], t["gate_open"], threshold=0.01)
    new = {k: np.atleast_1d(v.numpy()).astype(state[k].dtype) for k, v in t.items()}
    return x.numpy(), stats.numpy(), new


def diverge(state: dict, stats) -> bool:
    """EchoCanceller.apply_divergence_control on a state's weights."""
    if float(stats[1]) > 2.0 * float(stats[2]) + 1e-9:
        state["weights"] *= np.float32(0.5)
        return True
    return False


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def scenario(seed: int, frames: int, n: int):
    """(mic, far) frames: echo through a two-tap path under a noise floor,
    the path flipped for three frames (the filter then adds energy), near
    speech over the echo, and a silent tail that closes the gate."""
    rng = np.random.default_rng(seed)
    total = n * frames
    far = rng.normal(0, 0.2, total).astype(np.float32)
    path = np.zeros(11, np.float32)
    path[8], path[10] = 0.4, 0.1
    echo = np.convolve(far, path)[:total].astype(np.float32)
    mic = echo + rng.normal(0, 0.02, total).astype(np.float32)
    q = frames // 4
    flip = slice(q * n, (q + 3) * n)
    mic[flip] = -echo[flip] + rng.normal(0, 0.02, 3 * n).astype(np.float32)
    talk = slice(2 * q * n, (2 * q + 3) * n)
    mic[talk] += 0.3 * np.sin(2 * np.pi * 220 * np.arange(total)[talk] / SR).astype(np.float32)
    mic[(frames - 3) * n:] = 0.0
    far[(frames - 3) * n:] = 0.0
    return mic.reshape(frames, n), far.reshape(frames, n)


def run(lib, stages, taps, mic, far, exact: bool, in_place: bool = False) -> int:
    """Both versions over the frames; returns the divergence events."""
    es, ps = fresh_state(taps), fresh_state(taps)
    events = 0
    for k in range(len(mic)):
        eo, estats, es = emu_frame(lib, stages, mic[k], far[k], es, taps, in_place)
        po, pstats, ps = plain_frame(stages, mic[k], far[k], ps, taps)
        label = f"frame {k}"
        if exact:
            np.testing.assert_array_equal(bits(eo), bits(po), err_msg=label)
            np.testing.assert_array_equal(bits(es["weights"]), bits(ps["weights"]), err_msg=label)
        else:
            np.testing.assert_allclose(eo, po, **TOL, err_msg=label)
            np.testing.assert_allclose(es["weights"], ps["weights"], **TOL, err_msg=label)
        for name in ("far_tail", "hang", "gate_open"):
            np.testing.assert_array_equal(es[name], ps[name], err_msg=f"{label} {name}")
        for name in ("hp_in", "hp_out", "gate_env"):
            if exact:
                np.testing.assert_array_equal(bits(es[name]), bits(ps[name]), err_msg=label)
            else:
                np.testing.assert_allclose(es[name], ps[name], **TOL, err_msg=label)
        assert bits(estats[0]) == bits(pstats[0]), label  # frozen fraction
        np.testing.assert_allclose(estats[1:], pstats[1:], **TOL, err_msg=label)
        e_div, p_div = diverge(es, estats), diverge(ps, pstats)
        assert e_div == p_div, label
        events += e_div
    return events


@pytest.mark.parametrize("n", [1, 48, 480])
def test_one_tap_is_bit_exact(emulated, n):
    frames = {1: 200, 48: 24, 480: 8}[n]
    mic, far = scenario(n, frames, n)
    run(emulated, ALL, 1, mic, far, exact=True)


@pytest.mark.parametrize("taps,n,frames", [(64, 96, 24), (64, 1, 150), (64, 40, 12),
                                           (256, 480, 6), (256, 100, 8), (100, 64, 6)])
def test_taps_within_tolerance(emulated, taps, n, frames):
    """Windows of several weights a lane, frames shorter than the taps (the
    new far tail mixes the old tail and the frame), a tap count that is no
    multiple of 32. Where the flipped echo path spans whole frames, both
    versions halve the weights on the same frames."""
    mic, far = scenario(taps + n, frames, n)
    events = run(emulated, ALL, taps, mic, far, exact=False)
    if n >= 96:
        assert events >= 1


@pytest.mark.parametrize("n", [1, 100, 480, 960])
def test_without_aec_bit_exact(emulated, n):
    """Highpass and gate alone: every step rounds as the plain version does
    (the gate's update fused), so the output is bit for bit its own."""
    mic, far = scenario(n + 1, max(8, min(200, 2400 // n)), n)
    run(emulated, audio.STAGE_HIGHPASS | audio.STAGE_GATE, 0, mic, far, exact=True)


@pytest.mark.parametrize("stages", [audio.STAGE_AEC, audio.STAGE_HIGHPASS, audio.STAGE_GATE])
def test_each_stage_alone(emulated, stages):
    mic, far = scenario(stages, 8, 96)
    taps = 1 if stages & audio.STAGE_AEC else 0
    run(emulated, stages, taps, mic, far, exact=True)


def test_state_in_place(emulated):
    """The new state written over the old, as ClientAudioPipeline launches."""
    mic, far = scenario(7, 8, 96)
    run(emulated, ALL, 64, mic, far, exact=False, in_place=True)
    run(emulated, ALL, 1, mic, far, exact=True, in_place=True)


def test_quotient_is_the_ieee_division(emulated):
    """The NLMS update's quotient (a reciprocal a sample, then an fma
    correction per tap) equals float32 division bit for bit, over operands
    of the update's range and over random bit patterns of normal floats."""
    rng = np.random.default_rng(0)
    n = 1 << 21
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-60, 12, n)
         * rng.choice([-1, 1], n)).astype(np.float32)
    b = (rng.uniform(1, 2, n) * 10.0 ** rng.uniform(-6, 5, n)).astype(np.float32)
    raw = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.uint32).view(np.float32)
    ok = (np.abs(raw[0]) < 1e30) & (np.abs(raw[0]) > 1e-30) & (np.abs(raw[1]) < 1e30) & (
        np.abs(raw[1]) > 1e-6)
    a = np.concatenate([a, raw[0][ok], np.float32([0.0, -0.0])])
    b = np.concatenate([b, np.abs(raw[1][ok]), np.float32([3.0, 3.0])])
    out = np.empty_like(a)
    emulated.emu_quot.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
    emulated.emu_quot(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a))
    np.testing.assert_array_equal(bits(out), bits(a / b))


def test_rejects_what_it_cannot_take(emulated):
    state = fresh_state(4)
    z = np.zeros(4000, np.float32)
    consts = audio.capture_consts(1)
    buf = np.zeros(4003, np.float32)
    for n, taps, stages in ((0, 4, ALL), (audio.MAX_CAPTURE_SAMPLES + 1, 4, ALL),
                            (4, 0, ALL), (4, audio.MAX_TAPS + 1, ALL), (4, 4, 8)):
        rc = emulated.ac_capture_chain(z.ctypes.data, z.ctypes.data, n, taps, stages, 1440,
                                       *(a.ctypes.data for a in state.values()),
                                       consts.ctypes.data, buf.ctypes.data,
                                       *(a.ctypes.data for a in state.values()), None)
        assert rc != 0, (n, taps, stages)
