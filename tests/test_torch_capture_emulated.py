"""K5's source (csrc/capture.cu) run on the CPU under an emulation of the CUDA
block (tests/cuda_emu.h: 256 threads, barriers, warp shuffles, dynamic shared
memory that starts as NaNs), against the plain capture_chain_reference of
ops/audio.py, with the state carried from frame to frame as the client
carries it (divergence control halves the weights between frames on each
side, from its own stats).

K5 computes each sample's echo estimate through the blocked look-ahead's
correction form, so with adaptation on it agrees with the literal scan
within rtol=2e-4, atol=2e-5 (output and weights; the energies are sums in
another order), with the far tail, hangover, gate state and frozen fraction
exact. With a frozen filter (a hangover longer than the run carried in) the
estimate is w0.x_j, a single product at one tap, so the whole chain agrees
bit for bit; without the AEC it does too. Frames run from 1 to 3,072
samples, on both sides of each block boundary, at 1 to 1,024 taps; each
stage also runs alone, and in place (the new state over the old). It checks
the kernel's logic on every CPU test run; the compiled kernel is checked on
the card (test_torch_kernels.py, chip_smoke.py)."""

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
LAUNCH = r"kernel<<<1, kThreads, smem, \(cudaStream_t\)stream>>>\("
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
    src, n = re.subn(LAUNCH, "EMU_LAUNCH(kernel, kThreads, smem, ", src)
    assert n == 1, "the kernel's launch line changed: update LAUNCH"
    src, n = re.subn(DYNAMIC_SMEM, "float* const smem = static_cast<float*>(emu_dynamic_smem);",
                     src)
    assert n == 1, "the kernel's dynamic shared memory changed: update DYNAMIC_SMEM"
    # the kernel's quotient, for test_quotient_is_the_ieee_division
    src += ("\nextern \"C\" void emu_quot(const float* a, const float* b, float* out, long n) {\n"
            "  for (long i = 0; i < n; ++i) out[i] = quot_by(a[i], b[i], quot(1.0f, b[i]));\n}\n")
    (out_dir / "capture_emu.cpp").write_text(src)
    # the look-ahead crosses a barrier or a shuffle ~150 times a block: wait
    # for them by yielding (tests/cuda_emu.h)
    cmd = ["g++", "-std=c++20", "-O1", "-DEMU_SPIN_BARRIER", "-shared", "-fPIC", "-pthread",
           f"-I{TESTS}",
           f"-I{kernel_build.CSRC_DIR}", "-o", str(out_dir / "libcapture_emu.so"),
           str(out_dir / "capture_emu.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out_dir / "libcapture_emu.so"))
    lib.ac_capture_chain.argtypes = kernel_build.ENTRY_POINTS["ac_capture_chain"]
    lib.ac_capture_chain.restype = ctypes.c_int
    return lib


SOURCE = (kernel_build.CSRC_DIR / "capture.cu").read_text()
BLOCK = int(re.search(r"constexpr int kBlock = (\d+);", SOURCE).group(1))  # look-ahead block
HANGOVER = 1440
FROZEN = 10 ** 6  # a hangover that outlasts every run: the filter never adapts


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulated(SOURCE, tmp_path_factory.mktemp("emu"))


def fresh_state(taps: int, frozen: bool = False) -> dict:
    """The chain's state as numpy arrays, in K5's argument order; a frozen
    one carries seeded weights and a hangover of FROZEN samples."""
    weights = np.zeros(taps, np.float32)
    if frozen:
        weights = np.random.default_rng(taps).normal(0, 0.3, taps).astype(np.float32)
    return {"weights": weights, "far_tail": np.zeros(taps, np.float32),
            "hang": np.full(1, FROZEN if frozen else 0, np.int32),
            "hp_in": np.zeros(1, np.float32), "hp_out": np.zeros(1, np.float32),
            "gate_env": np.zeros(1, np.float32), "gate_open": np.zeros(1, np.uint8)}


def emu_frame(lib, stages, mic, far, state: dict, taps: int, in_place: bool = False,
              hangover: int = HANGOVER, hysteresis: float = 0.9):
    """One emulated K5 launch -> (out [n], stats [3], new state)."""
    n = len(mic)
    consts = audio.capture_consts(n, mu=0.5, geigel_t=0.5, hp_alpha=ALPHA,
                                  gate_threshold=0.01, hysteresis=hysteresis)
    buf = np.full(n + 3, np.nan, np.float32)
    # a stage that does not run leaves its state as it was
    new = state if in_place else {
        k: np.full_like(v, 7) if stages & stage else v.copy()
        for (k, v), stage in zip(state.items(), STAGE_OF)}
    mic = np.ascontiguousarray(mic, np.float32)
    far = np.ascontiguousarray(far, np.float32)
    rc = lib.ac_capture_chain(mic.ctypes.data, far.ctypes.data, n, taps, stages, hangover,
                              *(a.ctypes.data for a in state.values()), consts.ctypes.data,
                              buf.ctypes.data, *(a.ctypes.data for a in new.values()), None)
    assert rc == 0
    return buf[:n], buf[n:], new


def plain_frame(stages, mic, far, state: dict, taps: int, hangover: int = HANGOVER):
    """The plain version of the same stages -> (out, stats, new state)."""
    t = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    t["hang"], t["gate_open"] = t["hang"][0], t["gate_open"][0].bool()
    for k in ("hp_in", "hp_out", "gate_env"):
        t[k] = t[k][0]
    x, stats = torch.from_numpy(np.asarray(mic, np.float32)), torch.zeros(3)
    if stages & audio.STAGE_AEC:
        x, t["weights"], t["far_tail"], t["hang"], stats = audio.echo_cancel_reference(
            x, torch.from_numpy(np.asarray(far, np.float32)), t["weights"], t["far_tail"],
            t["hang"], taps=taps, hangover=hangover)
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
    flip = slice(q * n, min(q + 3, frames) * n)
    mic[flip] = -echo[flip] + rng.normal(0, 0.02, flip.stop - flip.start).astype(np.float32)
    talk = slice(2 * q * n, min(2 * q + 3, frames) * n)
    mic[talk] += 0.3 * np.sin(2 * np.pi * 220 * np.arange(total)[talk] / SR).astype(np.float32)
    mic[(frames - 3) * n:] = 0.0
    far[(frames - 3) * n:] = 0.0
    return mic.reshape(frames, n), far.reshape(frames, n)


def gate_frames(seed: int, peaks, lengths) -> list[np.ndarray]:
    """Noise frames of the given lengths, each scaled to the given peak."""
    rng = np.random.default_rng(seed)
    frames = []
    for peak, n in zip(peaks, lengths):
        x = rng.normal(0, 1, n)
        frames.append((x * (peak / np.abs(x).max())).astype(np.float32))
    return frames


# below both thresholds, between an open gate's at hysteresis 0.9 (0.009)
# and the closed one (0.01), between that and an open gate's at 1.5 (0.015),
# above both; each after an open and a closed gate, clear of the thresholds
GATE_PEAKS = [0.0125, 0.0125, 0.02, 0.0095, 0.0095, 0.0125, 0.005, 0.0125, 0.0125, 0.02, 0.02,
              0.0095, 0.0125, 0.005, 0.0125]


def run(lib, stages, taps, mic, far, exact: bool, in_place: bool = False,
        frozen: bool = False) -> int:
    """Both versions over the frames; returns the divergence events. A
    frozen run starts from fresh_state(taps, frozen=True) with a hangover of
    FROZEN samples, so no sample adapts."""
    es, ps = fresh_state(taps, frozen), fresh_state(taps, frozen)
    hangover = FROZEN if frozen else HANGOVER
    events = 0
    for k in range(len(mic)):
        eo, estats, es = emu_frame(lib, stages, mic[k], far[k], es, taps, in_place, hangover)
        po, pstats, ps = plain_frame(stages, mic[k], far[k], ps, taps, hangover)
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
    """A frozen filter at one tap: the echo estimate w0.x_j is one product."""
    frames = {1: 200, 48: 24, 480: 8}[n]
    mic, far = scenario(n, frames, n)
    run(emulated, ALL, 1, mic, far, exact=True, frozen=True)


@pytest.mark.parametrize("n", [1, 48, 480])
def test_one_tap_adapting_within_tolerance(emulated, n):
    frames = {1: 200, 48: 24, 480: 8}[n]
    mic, far = scenario(n, frames, n)
    run(emulated, ALL, 1, mic, far, exact=False)


@pytest.mark.parametrize("taps", [1, 32, 64, 256, 1024])
@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1, 100, 480, 3072])
def test_block_boundaries(emulated, n, taps):
    """Frames that end just before, on and just after a block boundary of
    the look-ahead, and across many blocks, at every weights-a-lane shape."""
    frames = {1: 8, 3072: 1}.get(n, 2)
    mic, far = scenario(n * 7 + taps, frames, n)
    run(emulated, ALL, taps, mic, far, exact=False)


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
    aec = bool(stages & audio.STAGE_AEC)
    run(emulated, stages, 64 if aec else 0, mic, far, exact=not aec)
    if aec:
        run(emulated, stages, 1, mic, far, exact=True, frozen=True)


@pytest.mark.parametrize("hysteresis", [0.9, 1.0, 1.5])
def test_gate_hysteresis(emulated, hysteresis):
    """The gate alone, from a closed gate and then carried, over frames whose
    peaks lie below the closed threshold, between it and an open gate's, and
    above both, of odd and even lengths: bit for bit the plain version. At
    hysteresis 1.5 a peak between the two opens and closes the gate in turn,
    sample by sample, so a frame of odd length leaves it in the other state."""
    lengths = [99 + k % 2 for k in range(len(GATE_PEAKS))]
    state = fresh_state(0)
    env, is_open = torch.tensor(0.0), torch.tensor(False)
    flips = 0
    for k, frame in enumerate(gate_frames(11, GATE_PEAKS, lengths)):
        out, _, state = emu_frame(emulated, audio.STAGE_GATE, frame, frame, state, 0,
                                  hysteresis=hysteresis)
        was = bool(is_open)
        want, env, is_open = audio.noise_gate_reference(torch.from_numpy(frame), env, is_open,
                                                        threshold=0.01, hysteresis=hysteresis)
        np.testing.assert_array_equal(bits(out), bits(want), err_msg=f"frame {k}")
        assert bits(state["gate_env"][0]) == bits(env) and bool(state["gate_open"][0]) == bool(
            is_open), k
        flips += GATE_PEAKS[k] == 0.0125 and bool(is_open) != was
    assert flips >= 2  # the run opens the gate on such peaks, twice


def test_state_in_place(emulated):
    """The new state written over the old, as ClientAudioPipeline launches."""
    mic, far = scenario(7, 8, 96)
    run(emulated, ALL, 64, mic, far, exact=False, in_place=True)
    run(emulated, ALL, 1, mic, far, exact=True, in_place=True, frozen=True)


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
