"""The port's capture chain (ops/audio.py: noise gate, highpass, echo
canceller, ClientAudioPipeline) against the JAX package's, on the CPU.

Inputs are made from numpy seeds and carried across frames. The highpass and
the gate are held bit for bit (the gate's envelope update is one fused
multiply-add in XLA's CPU code and in the plain version). The echo
canceller's output and weights are held within rtol=2e-4, atol=2e-5, the
bound tests/test_audio.py holds the JAX mixer to: its dot products sum in
another order. The hangover, the frozen fraction (a count times
float32(1/N), as jnp.mean takes it) and the divergence resets are decided by
comparisons of exact values, and are held equal. Scenarios follow
tests/test_audio.py: an echo-only stretch that converges past 10 dB ERLE,
double talk, a tone through the chain without the AEC, frames of 1, 100 and
480 samples, a far-end underrun and an echo path that flips sign (forced
divergence)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.ops import audio as jaudio
from asciichat_tpu_torch.ops import audio as taudio
from asciichat_tpu_torch.utils import convert
from test_torch_capture_emulated import GATE_PEAKS, gate_frames

TOL = dict(rtol=2e-4, atol=2e-5)
SR = jaudio.SAMPLE_RATE


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def echo_of(far: np.ndarray, delay: int = 8, gain: float = 0.5, sign: float = 1.0) -> np.ndarray:
    """A two-tap acoustic echo path (tests/test_audio.py:_echo_of)."""
    kernel = np.zeros(delay + 3, np.float32)
    kernel[delay] = sign * gain * 0.8
    kernel[delay + 2] = sign * gain * 0.2
    return np.convolve(far, kernel)[: len(far)].astype(np.float32)


def levels(seed: int, frames: int, n: int) -> np.ndarray:
    """A signal whose level per frame opens and closes the 0.01 gate: noise
    plus a tone, at levels well away from the thresholds."""
    rng = np.random.default_rng(seed)
    level = rng.choice([0.0, 0.002, 0.05, 0.3], frames)
    t = np.arange(frames * n) / SR
    sig = np.sin(2 * np.pi * 300 * t) + 0.5 * rng.standard_normal(t.size)
    return (sig * np.repeat(level, n)).astype(np.float32).reshape(frames, n)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_highpass_bit_exact():
    x = levels(1, 40, 480)
    alpha = jaudio.highpass_alpha(100.0)
    assert taudio.highpass_alpha(100.0) == alpha
    jin = jout = jnp.float32(0.0)
    tin = tout = torch.tensor(0.0)
    for k, frame in enumerate(x):
        jy, jin, jout = jaudio.highpass(jnp.asarray(frame), jin, jout, alpha)
        ty, tin, tout = taudio.highpass(torch.from_numpy(frame), tin, tout, alpha)
        np.testing.assert_array_equal(bits(ty), bits(jy), err_msg=f"frame {k}")
        assert bits(tin) == bits(jin) and bits(tout) == bits(jout), k


@pytest.mark.parametrize("n", [480, 100])
def test_noise_gate_bit_exact(n):
    x = levels(2 + n, 40, n)
    jenv, jopen = jnp.float32(0.0), jnp.asarray(False)
    tenv, topen = torch.tensor(0.0), torch.tensor(False)
    opened = closed = 0
    for k, frame in enumerate(x):
        jy, jenv, jopen = jaudio.noise_gate(jnp.asarray(frame), jenv, jopen)
        was = bool(topen)
        ty, tenv, topen = taudio.noise_gate(torch.from_numpy(frame), tenv, topen)
        np.testing.assert_array_equal(bits(ty), bits(jy), err_msg=f"frame {k}")
        assert bits(tenv) == bits(jenv) and bool(topen) == bool(jopen), k
        opened += bool(topen) and not was
        closed += was and not bool(topen)
    assert opened >= 2 and closed >= 2  # the run really opens and closes the gate


def test_noise_gate_hysteresis_above_one_like_jax():
    """At hysteresis 1.5 a peak between the closed threshold and an open
    gate's alternates the gate sample by sample; the plain gate does as
    JAX's does, bit for bit."""
    jenv, jopen = jnp.float32(0.0), jnp.asarray(True)
    tenv, topen = torch.tensor(0.0), torch.tensor(True)
    for k, frame in enumerate(gate_frames(12, GATE_PEAKS, [99 + k % 2 for k in
                                                           range(len(GATE_PEAKS))])):
        jy, jenv, jopen = jaudio.noise_gate(jnp.asarray(frame), jenv, jopen, hysteresis=1.5)
        ty, tenv, topen = taudio.noise_gate(torch.from_numpy(frame), tenv, topen,
                                            hysteresis=1.5)
        np.testing.assert_array_equal(bits(ty), bits(jy), err_msg=f"frame {k}")
        assert bits(tenv) == bits(jenv) and bool(topen) == bool(jopen), k


def test_noise_gate_batched_leading_dims():
    """The plain gate takes [..., N] as the JAX one does."""
    x = levels(9, 3, 64)
    jy, jenv, jopen = jaudio.noise_gate(jnp.asarray(x), jnp.zeros(3), jnp.zeros(3, bool))
    ty, tenv, topen = taudio.noise_gate(torch.from_numpy(x), torch.zeros(3),
                                        torch.zeros(3, dtype=torch.bool))
    np.testing.assert_array_equal(bits(ty), bits(jy))
    np.testing.assert_array_equal(bits(tenv), bits(jenv))


class Both:
    """The JAX and the port's echo canceller fed the same frames."""

    def __init__(self, taps: int, mu: float = 0.5, jax_state=None):
        self.j = jaudio.EchoCanceller(taps=taps, mu=mu)
        self.t = taudio.EchoCanceller(taps=taps, mu=mu, device="cpu")
        if jax_state is not None:
            self.j.weights, self.j.far_tail, self.j.hang = map(jnp.asarray, jax_state)
            self.t.weights, self.t.far_tail, self.t.hang = (
                torch.from_numpy(np.array(a)) for a in jax_state)

    def step(self, mic, far, label):
        jo = np.asarray(self.j.process(mic, far))
        to = self.t.process(mic, far).numpy()
        np.testing.assert_allclose(to, jo, **TOL, err_msg=label)
        np.testing.assert_allclose(self.t.weights.numpy(), np.asarray(self.j.weights), **TOL,
                                   err_msg=label)
        np.testing.assert_array_equal(self.t.far_tail.numpy(), np.asarray(self.j.far_tail))
        assert int(self.t.hang) == int(self.j.hang), label
        assert bits(self.t.double_talk_frac) == bits(self.j.double_talk_frac), label
        assert self.t.divergence_resets == self.j.divergence_resets, label
        return to


def test_echo_cancel_converges_like_jax():
    """Echo only at 64 taps for 50 frames: both pass 10 dB ERLE together."""
    rng = np.random.default_rng(3)
    n, frames = 480, 50
    far = rng.normal(0, 0.3, n * frames).astype(np.float32)
    echo = echo_of(far)
    both = Both(64, mu=0.7)
    res = []
    for k in range(frames):
        s = slice(k * n, (k + 1) * n)
        out = both.step(echo[s], far[s], f"frame {k}")
        res.append(float(np.mean(out ** 2)) / float(np.mean(echo[s] ** 2)))
    assert 10 * np.log10(1 / np.mean(res[-5:])) > 10


def test_double_talk_freezes_like_jax():
    """Echo, then near-end speech over it, then echo again, at 256 taps: the
    hangover and frozen fractions agree frame by frame."""
    rng = np.random.default_rng(1)
    n, frames = 480, 14
    far = rng.normal(0, 0.1, n * frames).astype(np.float32)
    mic = echo_of(far)
    near = (0.15 * np.sin(2 * np.pi * 440 * np.arange(n * frames) / SR)).astype(np.float32)
    mic[5 * n:10 * n] += near[5 * n:10 * n]
    both = Both(256)
    frozen = []
    for k in range(frames):
        s = slice(k * n, (k + 1) * n)
        both.step(mic[s], far[s], f"frame {k}")
        frozen.append(both.t.double_talk_frac)
    assert max(frozen[6:10]) > 0.5 and frozen[0] < 0.5


@pytest.mark.parametrize("n", [1, 100, 480])
def test_frame_lengths(n):
    """Frames shorter and longer than the 64 taps: the new far tail is the
    last taps samples of the old tail and the frame."""
    rng = np.random.default_rng(n)
    frames = {1: 300, 100: 20, 480: 6}[n]
    far = rng.normal(0, 0.2, n * frames).astype(np.float32)
    mic = echo_of(far) + rng.normal(0, 0.01, far.size).astype(np.float32)
    both = Both(64)
    for k in range(frames):
        s = slice(k * n, (k + 1) * n)
        both.step(mic[s], far[s], f"frame {k}")


def chain_frames(seed: int, frames: int, n: int = 480):
    """(mic, far) frames: echo only, a flipped echo path (the filter adds
    energy: divergence control halves it), double talk, and a stretch of
    silence that closes the gate."""
    rng = np.random.default_rng(seed)
    total = n * frames
    far = rng.normal(0, 0.2, total).astype(np.float32)
    mic = echo_of(far) + rng.normal(0, 0.02, total).astype(np.float32)
    q = frames // 4
    mic[q * n:(q + 3) * n] = (echo_of(far, sign=-1.0)[q * n:(q + 3) * n]
                              + rng.normal(0, 0.02, 3 * n).astype(np.float32))
    t = np.arange(total) / SR
    mic[2 * q * n:(2 * q + 4) * n] += (0.3 * np.sin(2 * np.pi * 220 * t))[2 * q * n:(2 * q + 4) * n]
    mic[(frames - 4) * n:] = 0.0
    far[(frames - 4) * n:] = 0.0
    return mic.reshape(frames, n), far.reshape(frames, n)


def jax_chain(p, mic):
    """jaudio.ClientAudioPipeline.process, which does not keep its stats."""
    return np.asarray(p.process(mic))


def run_pipelines(jp, tp, mic, far, underrun_at=()):
    """Both pipelines over the frames; at frames in ``underrun_at`` the far
    end delivers half a frame (the rest is zero-padded)."""
    n = mic.shape[1]
    for k in range(len(mic)):
        chunk = far[k][: n // 2] if k in underrun_at else far[k]
        jp.add_far(chunk)
        tp.add_far(chunk)
        jo = jax_chain(jp, mic[k])
        to = tp.process(mic[k])
        label = f"frame {k}"
        np.testing.assert_allclose(to, jo, **TOL, err_msg=label)
        assert bool(tp.gate_open) == bool(jp.gate_open), label
        np.testing.assert_allclose(float(tp.gate_env), float(jp.gate_env), **TOL,
                                   err_msg=label)
        if jp.aec is not None:
            np.testing.assert_allclose(tp.aec.weights.numpy(), np.asarray(jp.aec.weights),
                                       **TOL, err_msg=label)
            assert int(tp.aec.hang) == int(jp.aec.hang), label
            assert bits(tp.aec.double_talk_frac) == bits(jp.aec.double_talk_frac), label
            assert tp.aec.divergence_resets == jp.aec.divergence_resets, label
        assert tp._far_len == jp._far_len, label


def test_pipeline_matches_jax():
    """The whole chain at full width (256 taps, 480 samples, a 100 Hz
    highpass, a 0.01 gate) over 24 frames with an underrun, a flipped echo
    path and double talk."""
    mic, far = chain_frames(5, 24)
    jp = jaudio.ClientAudioPipeline()
    tp = taudio.ClientAudioPipeline(device="cpu")
    run_pipelines(jp, tp, mic, far, underrun_at=(3,))
    assert tp.aec.divergence_resets >= 1  # the flipped path diverged
    assert not bool(tp.gate_open)  # the silent tail closed the gate


def test_pipeline_without_aec_passes_a_tone():
    """use_aec=False (tests/test_audio.py:299-303): no far end is consumed,
    the tone passes the gate, bit for bit with JAX."""
    tone = (0.2 * np.sin(2 * np.pi * 440 * np.arange(4800) / SR)).astype(np.float32)
    jp = jaudio.ClientAudioPipeline(use_aec=False)
    tp = taudio.ClientAudioPipeline(use_aec=False, device="cpu")
    outs = []
    for i in range(0, 4800, 480):
        jo = jax_chain(jp, tone[i:i + 480])
        to = tp.process(tone[i:i + 480])
        np.testing.assert_array_equal(bits(to), bits(jo))
        outs.append(to)
    assert np.sqrt((np.concatenate(outs[5:]) ** 2).mean()) > 0.1


def test_capture_chain_functions_agree():
    """capture_chain on CPU tensors is capture_chain_reference, and each
    stage alone composes to it."""
    mic, far = chain_frames(8, 4, n=96)
    args = dict(use_aec=True, taps=32, mu=0.5, geigel_t=0.5, hangover=1440,
                gate_threshold=0.01)
    z = torch.tensor(0.0)
    state = (torch.zeros(32), torch.zeros(32), torch.tensor(0, dtype=torch.int32), z, z, z,
             torch.tensor(False))
    alpha = taudio.highpass_alpha(100.0)
    got = taudio.capture_chain(torch.from_numpy(mic[0]), torch.from_numpy(far[0]), *state,
                               alpha, **args)
    e, w, ft, h, stats = taudio.echo_cancel(torch.from_numpy(mic[0]), torch.from_numpy(far[0]),
                                            *state[:3], taps=32)
    y, hin, hout = taudio.highpass(e, z, z, alpha)
    out, env, opn = taudio.noise_gate(y, z, torch.tensor(False))
    for a, b in zip(got, (out, w, ft, h, hin, hout, env, opn, stats)):
        assert torch.equal(a, b)


def test_capture_state_carries_over_from_jax():
    """Ten frames in JAX, then both packages continue ten more from the JAX
    state (convert.capture_state)."""
    mic, far = chain_frames(11, 20)
    jp = jaudio.ClientAudioPipeline()
    for k in range(10):
        jp.add_far(far[k])
        jp.process(mic[k])
    tp = taudio.ClientAudioPipeline(device="cpu")
    state = convert.capture_state(jp, "cpu")
    assert {k: v.dtype for k, v in state.items() if k != "divergence_resets"} == {
        k: torch.from_numpy(np.zeros(0, d)).dtype for k, d in convert.CAPTURE_STATE.items()}
    assert state["weights"].shape == (256,) and state["divergence_resets"] == 0
    convert.load_capture_state(tp, state)
    for chunk in list(jp._far_chunks):  # the FIFO is host data: hand it over as is
        tp.add_far(chunk)
    run_pipelines(jp, tp, mic[10:], far[10:])


def test_capture_state_rejects_wrong_arrays():
    from types import SimpleNamespace

    z = np.float32(0.0)
    fake = SimpleNamespace(aec=None, hp_in=np.float64(0.0), hp_out=z, gate_env=z,
                           gate_open=np.bool_(False))
    with pytest.raises(ValueError, match="hp_in"):
        convert.capture_state(fake, "cpu")
    fake.hp_in = z
    state = convert.capture_state(fake, "cpu")
    assert "weights" not in state
    with pytest.raises(ValueError, match="echo canceller"):
        convert.load_capture_state(taudio.ClientAudioPipeline(device="cpu"), state)


def test_cpu_tensors_take_the_plain_chain():
    before = taudio.CAPTURE_KERNEL.launches
    p = taudio.ClientAudioPipeline(device="cpu")
    p.add_far(np.zeros(480, np.float32))
    out = p.process(np.zeros(480, np.float32))
    assert out.shape == (480,) and out.dtype == np.float32
    assert taudio.CAPTURE_KERNEL.launches == before


def test_pipeline_default_device_needs_a_card(monkeypatch):
    """With no device named, the pipeline takes the card; without one it
    raises (there is no silent CPU fallback), and ASCIICHAT_TORCH_DEVICE=cpu
    asks for the plain chain."""
    monkeypatch.delenv("ASCIICHAT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taudio.ClientAudioPipeline()
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    assert taudio.ClientAudioPipeline().device.type == "cpu"


def test_capture_consts_are_the_reference_expressions():
    k = dict(zip(taudio.CAPTURE_CONSTS, taudio.capture_consts(
        480, mu=0.5, geigel_t=0.5, hp_alpha=jaudio.highpass_alpha(100.0),
        gate_threshold=0.01)))
    f32 = np.float32
    assert k["inv_n"] == f32(1.0 / 480) and k["norm_eps"] == f32(1e-6)
    assert k["gate_threshold_open"] == f32(0.01 * 0.9)
    assert k["gate_attack"] == f32(1.0 - np.exp(-1.0 / (0.010 * SR + 1e-12)))
    assert k["hp_alpha"] == f32(jaudio.highpass_alpha(100.0))
    assert not taudio.capture_consts(480).flags.writeable  # cached: shared by every call
