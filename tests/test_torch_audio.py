"""The port's mixer (ops/audio.py) against the JAX package's mixer_process.

Inputs are speech-like bursts made from a numpy seed, with sources that drop
out and one tick where no source is active; the state is carried across 50
ticks and also handed over from the JAX package mid-run. Tolerance
rtol=2e-4, atol=2e-5: the bound tests/test_audio.py holds the JAX mixer to
against its float64 reference. The all-silent tick is exact: silence out
and the state unchanged bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.ops import audio as jaudio
from asciichat_tpu_torch.ops import audio as taudio
from asciichat_tpu_torch.utils import convert

TOL = dict(rtol=2e-4, atol=2e-5)
TICKS = 50
SILENT_TICK = 20


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def speech(seed: int, s: int, n: int, ticks: int) -> tuple[np.ndarray, np.ndarray]:
    """samples float32 [ticks, s, n] and active bool [ticks, s]: each source
    talks in bursts (a tone plus noise at a level between about -50 and
    +2 dBFS, held for a few ticks) and is silent or absent in between."""
    rng = np.random.default_rng(seed)
    t = np.arange(ticks * n) / jaudio.SAMPLE_RATE
    samples = np.zeros((s, ticks * n), np.float32)
    for i in range(s):
        tone = np.sin(2 * np.pi * rng.uniform(90, 400) * t) + 0.3 * rng.standard_normal(t.size)
        level = np.zeros(ticks)
        k = 0
        while k < ticks:
            run = int(rng.integers(1, 6))
            level[k:k + run] = rng.choice([0.0, 0.003, 0.02, 0.1, 0.4, 1.2]) * rng.uniform(0.8, 1.1)
            k += run
        samples[i] = tone * np.repeat(level, n)
    samples = samples.reshape(s, ticks, n).transpose(1, 0, 2).copy()
    active = rng.random((ticks, s)) < 0.85
    active[SILENT_TICK % ticks] = False
    return samples, active


def _run_both(samples, active, exclude_self, jstate=None, tstate=None):
    s = samples.shape[1]
    c = s if exclude_self else 1
    jstate = jstate if jstate is not None else jaudio.MixerState.init(s, c).astuple()
    tstate = tstate if tstate is not None else taudio.MixerState.init(s, c).astuple()
    for k in range(len(samples)):
        x, a = samples[k], active[k]
        jout, jstate = jaudio.mixer_process(jnp.asarray(x), jnp.asarray(a), jstate,
                                            exclude_self=exclude_self)
        before = tstate
        tout, tstate = taudio.mixer_process(torch.from_numpy(x), torch.from_numpy(a), tstate,
                                            exclude_self=exclude_self)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL,
                                   err_msg=f"tick {k}")
        for name, got, want in zip(convert.MIXER_STATE, tstate, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"tick {k} {name}")
        if not a.any():
            assert torch.count_nonzero(tout) == 0
            assert all(torch.equal(x, y) for x, y in zip(tstate, before)), k
    return jstate, tstate


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("n", [256, 480, 1000])
@pytest.mark.parametrize("s", [1, 2, 5, 9, 32])
def test_reference_matches_jax(s, n, exclude_self):
    samples, active = speech(100 * s + n, s, n, TICKS)
    _run_both(samples, active, exclude_self)


def test_state_carries_over_from_jax():
    """Ten ticks in JAX, then both packages continue from the JAX state."""
    samples, active = speech(7, 9, 480, 30)
    jstate = jaudio.MixerState.init(9, 9).astuple()
    for k in range(10):
        _, jstate = jaudio.mixer_process(jnp.asarray(samples[k]), jnp.asarray(active[k]),
                                         jstate)
    tstate = convert.mixer_state(tuple(np.asarray(a) for a in jstate), "cpu")
    assert all(t.dtype == torch.float32 for t in tstate)
    _run_both(samples[10:], active[10:], True, jstate, tstate)


def test_exclude_self_silences_the_only_speaker():
    x = np.zeros((3, 480), np.float32)
    x[0] = 0.5 * np.sin(np.arange(480) / 7)
    out, _ = taudio.mixer_process(torch.from_numpy(x), torch.ones(3, dtype=torch.bool),
                                  taudio.MixerState.init(3, 3).astuple())
    assert torch.count_nonzero(out[0]) == 0
    assert out[1].abs().max() > 0.01 and torch.equal(out[1], out[2])


@pytest.mark.parametrize("x", [-1.0, -0.7, 0.7, 1.0])
def test_soft_clip_matches_jax(x):
    got = taudio.soft_clip(torch.tensor([x], dtype=torch.float32), 0.7, 3.0)
    want = jaudio.soft_clip(jnp.asarray([x], jnp.float32), 0.7, 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if x == -1.0:  # the reference's sign defect: folds back toward -0.7
        assert -0.7 < float(got) < -0.48


def test_params_and_constants_match_jax():
    assert dataclasses.asdict(taudio.MixerParams()) == dataclasses.asdict(jaudio.MixerParams())
    for prop in ("duck_attack_coeff", "duck_release_coeff", "comp_attack_coeff",
                 "comp_release_coeff"):
        assert getattr(taudio.MixerParams(), prop) == getattr(jaudio.MixerParams(), prop)
    assert (taudio.MIXER_FRAME_SIZE, taudio.SAMPLE_RATE, taudio.AUDIO_FRAME_SAMPLES) == (
        jaudio.MIXER_FRAME_SIZE, jaudio.SAMPLE_RATE, jaudio.AUDIO_FRAME_SAMPLES)
    db = np.float32([-60.0, -6.0, 0.0, 3.5])
    np.testing.assert_array_equal(taudio.db_to_linear(torch.from_numpy(db)).numpy(),
                                  np.asarray(jaudio.db_to_linear(jnp.asarray(db))))


def test_mixer_consts_are_the_reference_expressions():
    p = taudio.MixerParams()
    k = dict(zip(taudio.MIXER_CONSTS, taudio.mixer_consts(p)))
    f32 = np.float32
    assert k["duck_attack"] == f32(p.duck_attack_coeff)
    assert k["comp_release"] == f32(p.comp_release_coeff)
    assert k["speaking_floor"] == f32(np.asarray(jaudio.db_to_linear(-60.0)))
    assert k["duck_atten_lin"] == f32(np.asarray(jaudio.db_to_linear(p.duck_atten_db)))
    assert k["comp_slope"] == f32(-0.75) and k["comp_half_knee"] == f32(1.0)
    assert k["clip_hi_scale"] == f32(1.0 - 0.7) and k["clip_lo_scale"] == f32(-1.0 + 0.7)


def test_cpu_tensors_take_the_plain_mixer():
    before = taudio.MIXER_KERNEL.launches
    x = torch.zeros((2, 300))
    out, state = taudio.mixer_process(x, torch.tensor([True, False]),
                                      taudio.MixerState.init(2, 2).astuple())
    assert out.shape == (2, 300) and len(state) == 4
    out, _ = taudio.mixer_process(x, torch.tensor([True, False]),
                                  taudio.MixerState.init(2, 1).astuple(), exclude_self=False)
    assert out.shape == (1, 300)
    assert taudio.MIXER_KERNEL.launches == before


def test_mixer_state_carry_rejects_wrong_arrays():
    with pytest.raises(ValueError, match="4"):
        convert.mixer_state((np.zeros(2, np.float32),) * 3, "cpu")
    with pytest.raises(ValueError, match="duck_gain"):
        convert.mixer_state((np.zeros(2, np.float32), np.zeros(2, np.float64),
                             np.zeros(2, np.float32), np.zeros(2, np.float32)), "cpu")
