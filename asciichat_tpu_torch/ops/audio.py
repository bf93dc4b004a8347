"""The server's exclude-self audio mixer: ducking, crowd gain, compression
and soft clip for every listener in one call per 10 ms tick.

Counterpart of the mixer half of ``asciichat_tpu/ops/audio.py`` (:35-244;
that module imports JAX at the top, so the constants, ``MixerParams`` and the
scalar helpers are copied here, and the tests hold each equal to its
original). On a CUDA tensor :func:`mixer_process` launches K4
(``csrc/mixer.cu``), which runs the whole tick's scan over 256-sample frames
in one launch; on a CPU tensor it runs the plain version,
:func:`mixer_process_reference`, a loop over the frames. Neither falls back to
the other.

Semantics kept from the reference (lib/audio/mixer.c): zero padding to a
multiple of 256; inactive sources contribute silence and their envelope is
frozen; the speaking gate at -60 dB; ducking leadership over all sources;
each listener's crowd gain counts the speakers other than itself; per-listener
compression; soft clip with the reference's negative-branch sign defect; and
on a tick where no source is active, silence out with the state untouched.

The client-side capture DSP of the same JAX module (noise gate, filters,
resampler, level analysis, echo canceller) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from asciichat_tpu_torch.runtime.device import check_tensor, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel

MIXER_FRAME_SIZE = 256  # mixer.h:114
SAMPLE_RATE = 48_000  # audio.h:85-91 (48 kHz mono)
AUDIO_FRAME_SAMPLES = 480  # 10 ms ticks
MAX_SOURCES = 32  # K4 keeps one warp lane per source (MAX_CLIENTS, apps/server.py)

MIXER_KERNEL = Kernel(
    "mixer", "ac_mixer", "asciichat_tpu_torch/csrc/mixer.cu",
    "asciichat_tpu/ops/audio.py:155")


def db_to_linear(db):
    return torch.pow(10.0, torch.as_tensor(db, dtype=torch.float32) / 20.0)


def linear_to_db(linear):
    return 20.0 * torch.log10(torch.clamp_min(linear, 1e-12))


def _coeff(tau_s: float, sample_rate: float) -> float:
    """exp(-1/(tau*sr + eps)) (mixer.c:64-67, 130-133)."""
    return math.exp(-1.0 / (tau_s * sample_rate + 1e-12))


@dataclasses.dataclass(frozen=True)
class MixerParams:
    sample_rate: int = SAMPLE_RATE
    # ducking (mixer.c:121-125)
    duck_threshold_db: float = -45.0
    duck_margin_db: float = 6.0
    duck_atten_db: float = -6.0
    duck_attack_s: float = 0.010
    duck_release_s: float = 0.200
    # compressor (mixer.c:51, 54-61)
    comp_threshold_db: float = -10.0
    comp_ratio: float = 4.0
    comp_knee_db: float = 2.0
    comp_attack_s: float = 0.010
    comp_release_s: float = 0.100
    comp_makeup_db: float = 0.0
    # bus (mixer.c:328-329)
    crowd_alpha: float = 0.5
    base_gain: float = 1.0
    # soft clip (mixer.c:628)
    clip_threshold: float = 0.7
    clip_steepness: float = 3.0

    @property
    def duck_attack_coeff(self) -> float:
        return _coeff(self.duck_attack_s, self.sample_rate)

    @property
    def duck_release_coeff(self) -> float:
        return _coeff(self.duck_release_s, self.sample_rate)

    @property
    def comp_attack_coeff(self) -> float:
        return _coeff(self.comp_attack_s, self.sample_rate)

    @property
    def comp_release_coeff(self) -> float:
        return _coeff(self.comp_release_s, self.sample_rate)


@dataclasses.dataclass
class MixerState:
    """Carried across ticks. S sources, C output channels (clients)."""

    envelope: torch.Tensor  # [S] ducking envelope per source
    duck_gain: torch.Tensor  # [S]
    comp_envelope: torch.Tensor  # [C]
    comp_gain: torch.Tensor  # [C]

    @staticmethod
    def init(num_sources: int, num_clients: int,
             device: torch.device | str = "cpu") -> "MixerState":
        def full(n, v):
            return torch.full((n,), v, dtype=torch.float32, device=device)

        return MixerState(envelope=full(num_sources, 0.0), duck_gain=full(num_sources, 1.0),
                          comp_envelope=full(num_clients, 0.0),
                          comp_gain=full(num_clients, 1.0))

    def astuple(self):
        return (self.envelope, self.duck_gain, self.comp_envelope, self.comp_gain)


def soft_clip(x, threshold: float, steepness: float):
    """tanh knee above +-threshold (mixer.c:1030-1041), with the reference's
    deliberate negative-branch sign defect: (-1.0 + threshold) makes the
    curve fold back toward -threshold for deep negative samples
    (asciichat_tpu/ops/audio.py:115-129 says why it ships)."""
    hi = threshold + (1.0 - threshold) * torch.tanh((x - threshold) * steepness)
    lo = -threshold + (-1.0 + threshold) * torch.tanh((x + threshold) * steepness)
    return torch.where(x > threshold, hi, torch.where(x < -threshold, lo, x))


def _compressor_gain_reduction_db(p: MixerParams, level_db):
    """Soft-knee downward compression curve (mixer.c:70-86)."""
    over = level_db - p.comp_threshold_db
    knee = p.comp_knee_db
    slope = 1.0 / p.comp_ratio - 1.0
    x = over + knee * 0.5
    soft = slope * (x * x) / (2.0 * knee)
    return torch.where(over <= -knee * 0.5, 0.0,
                       torch.where(over >= knee * 0.5, slope * over, soft))


def _attack_release(value, target, attack_coeff, release_coeff):
    """ENVELOPE smoothing: attack when the level RISES (mixer.c:92-95)."""
    coeff = torch.where(target > value, attack_coeff, release_coeff)
    return coeff * value + (1.0 - coeff) * target


def _gain_smooth(value, target, attack_coeff, release_coeff):
    """GAIN smoothing: attack when the gain FALLS (mixer.c:102-106, 209-214)."""
    coeff = torch.where(target < value, attack_coeff, release_coeff)
    return coeff * value + (1.0 - coeff) * target


def mixer_process_reference(
    samples: torch.Tensor,  # float32 [S, N] source audio for this tick
    active: torch.Tensor,  # bool [S] sources that delivered audio
    state: tuple,  # MixerState.astuple()
    params: MixerParams = MixerParams(),
    exclude_self: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """Plain version: one mixer tick -> per-client mixes [C, N] and the
    updated state, as a loop over 256-sample frames
    (asciichat_tpu/ops/audio.py:155-244). With exclude_self, C == S and
    output[c] omits source c; without, C == 1 and output[0] is the full mix."""
    s_count, n = samples.shape
    p = params
    pad = (-n) % MIXER_FRAME_SIZE
    padded = torch.nn.functional.pad(samples, (0, pad))
    chunks = padded.reshape(s_count, -1, MIXER_FRAME_SIZE).transpose(0, 1)  # [F, S, frame]
    activef = active.to(torch.float32)
    env, duck_gain, comp_env, comp_gain = state
    outs = []
    for chunk in chunks:  # chunk [S, frame]
        chunk = chunk * activef[:, None]  # inactive sources contribute silence

        # Frame-peak envelope per source; only active sources update (mixer.c:557-580)
        peak = torch.amax(torch.abs(chunk), dim=1)
        new_env = _attack_release(env, peak, p.duck_attack_coeff, p.duck_release_coeff)
        env = torch.where(active, new_env, env)

        speaking = torch.logical_and(active, env > db_to_linear(-60.0))
        speaking_count = torch.sum(speaking.to(torch.float32))

        # Ducking over all slots (ducking_process_frame, mixer.c:185-216)
        env_db = linear_to_db(env)
        max_db = torch.amax(env_db)
        is_speaking = env_db > p.duck_threshold_db
        is_leader = torch.logical_and(is_speaking, env_db >= max_db - p.duck_margin_db)
        target = torch.where(torch.logical_and(is_speaking, ~is_leader),
                             db_to_linear(p.duck_atten_db), 1.0)
        duck_gain = _gain_smooth(duck_gain, target, p.duck_attack_coeff, p.duck_release_coeff)

        # Pre-crowd weighting; crowd/base applied per LISTENER
        weighted0 = chunk * (duck_gain * activef)[:, None]  # [S, frame]
        full0 = torch.sum(weighted0, dim=0)  # [frame]
        if exclude_self:
            # the listener is masked out before counting speakers
            # (mixer.c:663-665,780-787)
            count_excl = speaking_count - speaking.to(torch.float32)  # [S]
            crowd = torch.where(
                count_excl > 0,
                1.0 / torch.pow(torch.clamp_min(count_excl, 1.0), p.crowd_alpha),
                1.0)
            mixes = (full0[None, :] - weighted0) * (p.base_gain * crowd)[:, None]
        else:
            crowd = torch.where(
                speaking_count > 0,
                1.0 / torch.pow(torch.clamp_min(speaking_count, 1.0), p.crowd_alpha),
                1.0)
            mixes = full0[None, :] * (p.base_gain * crowd)

        # Per-client frame-peak compression (mixer.c:608-628)
        frame_peak = torch.amax(torch.abs(mixes), dim=1)  # [C]
        comp_env = _attack_release(comp_env, frame_peak, p.comp_attack_coeff,
                                   p.comp_release_coeff)
        gr_db = _compressor_gain_reduction_db(p, linear_to_db(comp_env))
        target_lin = db_to_linear(gr_db + p.comp_makeup_db)
        comp_gain = _gain_smooth(comp_gain, target_lin, p.comp_attack_coeff,
                                 p.comp_release_coeff)

        outs.append(soft_clip(mixes * comp_gain[:, None], p.clip_threshold,
                              p.clip_steepness))
    c_count = s_count if exclude_self else 1
    out = torch.cat(outs, dim=1)[:, :n] if outs else samples.new_zeros((c_count, 0))
    # no active source: the C mixer returns silence WITHOUT touching state
    # (mixer.c:509-512)
    any_active = torch.any(active)
    out = torch.where(any_active, out, 0.0)
    new_state = tuple(torch.where(any_active, new, old)
                      for new, old in zip((env, duck_gain, comp_env, comp_gain), state))
    return out, new_state


# MixerConsts of csrc/mixer_math.cuh, in its field order.
MIXER_CONSTS = (
    "duck_attack", "duck_release", "comp_attack", "comp_release", "speaking_floor",
    "duck_threshold_db", "duck_margin_db", "duck_atten_lin", "comp_threshold_db",
    "comp_half_knee", "comp_slope", "comp_two_knee", "comp_makeup_db", "crowd_alpha",
    "base_gain", "clip_threshold", "clip_hi_scale", "clip_lo_scale", "clip_steepness",
)


@functools.lru_cache(maxsize=16)
def mixer_consts(p: MixerParams) -> np.ndarray:
    """K4's float32 parameters, read-only. Each is the Python-float
    expression of the reference rounded once to float32, as JAX's weak typing
    rounds it; the two dB levels go through :func:`db_to_linear` in float32,
    as the reference computes them."""
    values = {
        "duck_attack": p.duck_attack_coeff, "duck_release": p.duck_release_coeff,
        "comp_attack": p.comp_attack_coeff, "comp_release": p.comp_release_coeff,
        "speaking_floor": float(db_to_linear(-60.0)),
        "duck_threshold_db": p.duck_threshold_db, "duck_margin_db": p.duck_margin_db,
        "duck_atten_lin": float(db_to_linear(p.duck_atten_db)),
        "comp_threshold_db": p.comp_threshold_db,
        "comp_half_knee": p.comp_knee_db * 0.5,
        "comp_slope": 1.0 / p.comp_ratio - 1.0, "comp_two_knee": 2.0 * p.comp_knee_db,
        "comp_makeup_db": p.comp_makeup_db, "crowd_alpha": p.crowd_alpha,
        "base_gain": p.base_gain, "clip_threshold": p.clip_threshold,
        "clip_hi_scale": 1.0 - p.clip_threshold, "clip_lo_scale": -1.0 + p.clip_threshold,
        "clip_steepness": p.clip_steepness,
    }
    out = np.array([values[k] for k in MIXER_CONSTS], np.float32)
    out.flags.writeable = False
    return out


def mixer_process(
    samples: torch.Tensor,
    active: torch.Tensor,
    state: tuple,
    params: MixerParams = MixerParams(),
    exclude_self: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """One mixer tick: K4 on a CUDA device, the plain
    :func:`mixer_process_reference` on the CPU. Returns the mixes [C, N] and
    new state tensors (the inputs are not written)."""
    if samples.device.type == "cpu":
        return mixer_process_reference(samples, active, state, params, exclude_self)
    dev = samples.device
    check_tensor(samples, "samples", torch.float32, (None, None), dev)
    s, n = samples.shape
    if not 1 <= s <= MAX_SOURCES:
        raise ValueError(f"samples: {s} sources, K4 takes 1 to {MAX_SOURCES}")
    c = s if exclude_self else 1
    check_tensor(active, "active", torch.bool, (s,), dev)
    for name, t, size in zip(("envelope", "duck_gain", "comp_envelope", "comp_gain"),
                             state, (s, s, c, c)):
        check_tensor(t, name, torch.float32, (size,), dev)
    out = torch.empty((c, n), dtype=torch.float32, device=dev)
    new_state = tuple(torch.empty_like(t) for t in state)
    consts = mixer_consts(params)
    with torch.cuda.device(dev):
        MIXER_KERNEL(samples.data_ptr(), active.data_ptr(), s, n,
                     *(t.data_ptr() for t in state), int(exclude_self),
                     consts.ctypes.data, out.data_ptr(),
                     *(t.data_ptr() for t in new_state), stream_handle(dev))
    return out, new_state
