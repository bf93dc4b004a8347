"""The server's exclude-self audio mixer and the client's capture chain.

Counterpart of ``asciichat_tpu/ops/audio.py`` (that module imports JAX at
the top, so the constants, ``MixerParams`` and the scalar helpers are copied
here, and the tests hold each equal to its original). The library tail
(:func:`lowpass`, :func:`resample_linear`, :func:`analyze_levels`) is plain
PyTorch on the buffer's device: nothing in the port calls it. Neither
kernel wrapper falls back to the plain version, nor the plain version to
the kernel:

- the mixer: ducking, crowd gain, compression and soft clip for every
  listener in one call per 10 ms tick. On a CUDA tensor :func:`mixer_process`
  launches K4 (``csrc/mixer.cu``), which runs the whole tick's scan over
  256-sample frames in one launch; on a CPU tensor it runs the plain version,
  :func:`mixer_process_reference`, a loop over the frames. Semantics kept from
  the reference (lib/audio/mixer.c): zero padding to a multiple of 256;
  inactive sources contribute silence and their envelope is frozen; the
  speaking gate at -60 dB; ducking leadership over all sources; each
  listener's crowd gain counts the speakers other than itself; per-listener
  compression; soft clip with the reference's negative-branch sign defect;
  and on a tick where no source is active, silence out with the state
  untouched.
- the capture chain a mic frame runs on the client before it is sent: NLMS
  echo cancellation with a Geigel double-talk freeze, a one-pole highpass and
  a noise gate (:func:`echo_cancel`, :func:`highpass`, :func:`noise_gate`, and
  all three as :func:`capture_chain`). On a CUDA tensor each launches K5
  (``csrc/capture.cu``) for the stages it names; on a CPU tensor it runs its
  plain version (``*_reference``), a per-sample loop in float32 in the JAX
  package's order of operations. :class:`ClientAudioPipeline` carries the
  chain's state across 10 ms frames on its device and feeds the echo
  canceller the received playback as its far-end reference.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from asciichat_tpu_torch.runtime.device import check_tensor, default_device, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel

MIXER_FRAME_SIZE = 256  # mixer.h:114
SAMPLE_RATE = 48_000  # audio.h:85-91 (48 kHz mono)
AUDIO_FRAME_SAMPLES = 480  # 10 ms ticks
MAX_SOURCES = 32  # K4 keeps one warp lane per source (MAX_CLIENTS, apps/server.py)

MIXER_KERNEL = Kernel(
    "mixer", "ac_mixer", "asciichat_tpu_torch/csrc/mixer.cu",
    "asciichat_tpu/ops/audio.py:156")


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


# ---------------------------------------------------------------------------
# The client's capture chain (asciichat_tpu/ops/audio.py:247-589): echo
# cancellation against the far-end playback, DC-removal highpass, noise gate.

CAPTURE_KERNEL = Kernel(
    "capture_chain", "ac_capture_chain", "asciichat_tpu_torch/csrc/capture.cu",
    "asciichat_tpu/ops/audio.py:476")

# K5's stages, a bit each (csrc/capture.cu kStage*)
STAGE_AEC, STAGE_HIGHPASS, STAGE_GATE = 1, 2, 4
MAX_TAPS = 1024  # K5's mat-vec holds 32 weights a lane
MAX_CAPTURE_SAMPLES = 3072  # K5 keeps a frame and its per-sample terms in shared memory

# CaptureConsts of csrc/capture.cu, in its field order.
CAPTURE_CONSTS = ("mu", "geigel_t", "norm_eps", "hp_alpha", "gate_threshold",
                  "gate_threshold_open", "gate_attack", "gate_release", "inv_n")
NORM_EPS = 1e-6  # NLMS regulariser (audio.py:410)


def _gate_coeffs(attack_s: float, release_s: float, sample_rate: float) -> tuple[float, float]:
    """1 - exp(-1/(tau*sr + eps)) for attack and release (audio.py:262-263)."""
    return (1.0 - math.exp(-1.0 / (attack_s * sample_rate + 1e-12)),
            1.0 - math.exp(-1.0 / (release_s * sample_rate + 1e-12)))


def highpass_alpha(cutoff_hz: float, sample_rate: float = SAMPLE_RATE) -> float:
    return 1.0 / (1.0 + 2.0 * math.pi * cutoff_hz / sample_rate)


def _f32(value, device) -> torch.Tensor:
    """A Python float rounded once to a float32 scalar, as JAX's weak typing
    rounds it."""
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def lowpass(buf, prev_out, alpha):
    """y[n] = alpha*x[n] + (1-alpha)*y[n-1] (mixer.c:1004-1013) over buf
    [..., N], a loop over the samples with alpha in float32 -> (out,
    prev_out)."""
    a = _f32(alpha, buf.device)
    keep = 1.0 - a
    pout = prev_out
    outs = []
    for x in torch.unbind(buf, dim=-1):
        pout = a * x + keep * pout
        outs.append(pout)
    return (torch.stack(outs, dim=-1) if outs else buf.clone()), pout


def lowpass_alpha(cutoff_hz: float, sample_rate: float = SAMPLE_RATE) -> float:
    dt = 1.0 / sample_rate
    rc = 1.0 / (2.0 * math.pi * cutoff_hz)
    return dt / (rc + dt)


def resample_linear(buf: torch.Tensor, out_len: int) -> torch.Tensor:
    """[..., N] -> [..., out_len] linear interpolation. Positions are
    ``i * (N / out_len)`` in float32 with an end clamp, as the C resampler
    strides (audio.c:578-586), not endpoint-matched."""
    n = buf.shape[-1]
    ratio = n / max(out_len, 1)
    pos = torch.arange(out_len, dtype=torch.float32, device=buf.device) * ratio
    i0 = pos.to(torch.int32).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(0, n - 1)
    frac = pos - i0.to(torch.float32)
    return (buf.index_select(-1, i0.long()) * (1.0 - frac)
            + buf.index_select(-1, i1.long()) * frac)


def analyze_levels(buf: torch.Tensor) -> dict[str, torch.Tensor]:
    """[..., N] -> {'rms', 'peak', 'rms_db', 'peak_db'} per leading batch
    dims (lib/audio/analysis.c). The mean multiplies by float32(1/N), as
    ``jnp.mean`` does."""
    rms = torch.sqrt((buf * buf).sum(-1) * _f32(1.0 / buf.shape[-1], buf.device))
    peak = buf.abs().amax(-1)
    return {"rms": rms, "peak": peak, "rms_db": linear_to_db(rms),
            "peak_db": linear_to_db(peak)}


def noise_gate_reference(buf, envelope, gate_open, threshold: float = 0.01,
                         attack_s: float = 0.010, release_s: float = 0.050,
                         hysteresis: float = 0.9, sample_rate: int = SAMPLE_RATE):
    """Plain version of :func:`noise_gate`: buf [..., N] -> (gated buf,
    envelope, gate_open), a loop over the samples (audio.py:251-278). The
    gate decides on the buffer's peak, with hysteresis; the envelope's update
    ``env + coeff * (target - env)`` is one fused multiply-add, as XLA
    compiles it: taken in float64, where the product of two float32s is
    exact, and rounded once."""
    attack_c, release_c = _gate_coeffs(attack_s, release_s, sample_rate)
    dev = buf.device
    thr_closed, thr_open = _f32(threshold, dev), _f32(threshold * hysteresis, dev)
    attack, release = _f32(attack_c, dev), _f32(release_c, dev)
    peak = torch.amax(torch.abs(buf), dim=-1)
    env, is_open = envelope, gate_open
    outs = []
    for x in torch.unbind(buf, dim=-1):
        thr = torch.where(is_open, thr_open, thr_closed)
        target = (peak > thr).to(torch.float32)
        is_open = target > 0.5
        coeff = torch.where(target > env, attack, release)
        env = (coeff.double() * (target - env).double() + env.double()).float()
        outs.append(x * env)
    return (torch.stack(outs, dim=-1) if outs else buf.clone()), env, is_open


def highpass_reference(buf, prev_in, prev_out, alpha):
    """Plain version of :func:`highpass`: y[n] = alpha * (y[n-1] + x[n] -
    x[n-1]) over buf [..., N] (audio.py:285-295), alpha in float32."""
    a = _f32(alpha, buf.device)
    pin, pout = prev_in, prev_out
    outs = []
    for x in torch.unbind(buf, dim=-1):
        y = a * ((pout + x) - pin)
        pin, pout = x, y
        outs.append(y)
    return (torch.stack(outs, dim=-1) if outs else buf.clone()), pin, pout


def echo_cancel_reference(mic, far, weights, far_tail, hang, taps: int = 256,
                          mu: float = 0.5, geigel_t: float = 0.5, hangover: int = 1440):
    """Plain version of :func:`echo_cancel` (audio.py:379-421): mic, far [N]
    -> (echo-cancelled mic [N], weights, far_tail, hang, stats [3]).

    NLMS ``w += mu * e * x / (x.x + 1e-6)`` per sample over the window of
    the last ``taps`` far samples, which ends at the current one; adaptation
    freezes while the Geigel detector (|mic| > geigel_t * max|x|) and its
    hangover hold. The window's peak and energy and the hangover do not
    depend on the weights, so they are taken for all samples at once; the
    weights then run the literal per-sample loop. stats: [frozen fraction
    (the count times float32(1/N), as jnp.mean takes it), sum(out^2),
    sum(mic^2)]."""
    n = mic.shape[0]
    far_hist = torch.cat([far_tail, far])  # [taps + N]
    windows = far_hist.unfold(0, taps, 1)[1:]  # [N, taps]: row i ends at far[i]
    dt = (torch.abs(mic) > geigel_t * torch.amax(torch.abs(windows), dim=1)).tolist()
    norms = torch.sum(windows * windows, dim=1) + NORM_EPS
    h = int(hang)
    adapt = []
    for d in dt:
        h = hangover if d else max(h - 1, 0)
        adapt.append(h == 0)
    adapt = torch.tensor(adapt, dtype=torch.float32, device=mic.device)
    gains = (adapt * mu).unbind()
    w = weights
    outs = []
    for x, m, g, norm in zip(windows.unbind(), mic.unbind(), gains, norms.unbind()):
        e = m - torch.dot(w, x)
        w = w + g * e * x / norm
        outs.append(e)
    out = torch.stack(outs) if outs else mic.clone()
    frozen = torch.sum(1.0 - adapt) * _f32(1.0 / max(n, 1), mic.device)
    stats = torch.stack([frozen, torch.sum(out * out), torch.sum(mic * mic)])
    return (out, w, far_hist[-taps:].clone(),
            torch.tensor(h, dtype=torch.int32, device=mic.device), stats)


def capture_chain_reference(mic, far, weights, far_tail, hang, hp_in, hp_out, gate_env,
                            gate_open, hp_alpha, *, use_aec: bool, taps: int, mu: float,
                            geigel_t: float, hangover: int, gate_threshold: float):
    """Plain version of :func:`capture_chain`: echo cancellation (when
    ``use_aec``), highpass, noise gate (audio.py:474-494). Returns (out,
    weights, far_tail, hang, hp_in, hp_out, gate_env, gate_open, stats)."""
    if use_aec:
        x, weights, far_tail, hang, stats = echo_cancel_reference(
            mic, far, weights, far_tail, hang, taps=taps, mu=mu, geigel_t=geigel_t,
            hangover=hangover)
    else:
        x, stats = mic, torch.zeros(3, dtype=torch.float32, device=mic.device)
    x, hp_in, hp_out = highpass_reference(x, hp_in, hp_out, hp_alpha)
    x, gate_env, gate_open = noise_gate_reference(x, gate_env, gate_open,
                                                  threshold=gate_threshold)
    return x, weights, far_tail, hang, hp_in, hp_out, gate_env, gate_open, stats


@functools.lru_cache(maxsize=64)
def capture_consts(n: int, mu: float = 0.0, geigel_t: float = 0.0, hp_alpha: float = 0.0,
                   gate_threshold: float = 0.0, attack_s: float = 0.010,
                   release_s: float = 0.050, hysteresis: float = 0.9,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """K5's float32 parameters for an N-sample frame, read-only: each the
    Python-float expression of the reference rounded once to float32."""
    attack_c, release_c = _gate_coeffs(attack_s, release_s, sample_rate)
    values = {"mu": mu, "geigel_t": geigel_t, "norm_eps": NORM_EPS, "hp_alpha": hp_alpha,
              "gate_threshold": gate_threshold,
              "gate_threshold_open": gate_threshold * hysteresis,
              "gate_attack": attack_c, "gate_release": release_c, "inv_n": 1.0 / max(n, 1)}
    out = np.array([values[k] for k in CAPTURE_CONSTS], np.float32)
    out.flags.writeable = False
    return out


# K5's carried state, in its argument order: weights [taps] and far_tail
# [taps] float32, hang int32, hp_in, hp_out and gate_env float32, gate_open
# bool (each scalar a 0-d tensor); None for a stage that does not run.
_STATE = (("weights", torch.float32), ("far_tail", torch.float32), ("hang", torch.int32),
          ("hp_in", torch.float32), ("hp_out", torch.float32), ("gate_env", torch.float32),
          ("gate_open", torch.bool))
_STAGE_OF = (STAGE_AEC, STAGE_AEC, STAGE_AEC, STAGE_HIGHPASS, STAGE_HIGHPASS, STAGE_GATE,
             STAGE_GATE)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def capture_launch(stages: int, mic: torch.Tensor, far: torch.Tensor | None, state: tuple,
                   consts: np.ndarray, taps: int = 0, hangover: int = 0,
                   buf: torch.Tensor | None = None, new_state: tuple | None = None):
    """One K5 launch over an N-sample frame on the current stream: the
    ``stages`` (STAGE_* bits) in the order AEC, highpass, gate. Returns
    ``buf`` (float32 [N + 3]: the output, then the AEC's stats, zeros
    without it) and the new state. ``new_state`` may be ``state`` itself:
    the kernel reads all of its state before it writes any."""
    dev = mic.device
    check_tensor(mic, "mic", torch.float32, (None,), dev)
    n = mic.shape[0]
    if not 1 <= n <= MAX_CAPTURE_SAMPLES:
        raise ValueError(f"mic: {n} samples, K5 takes 1 to {MAX_CAPTURE_SAMPLES}")
    if stages & STAGE_AEC:
        if not 1 <= taps <= MAX_TAPS:
            raise ValueError(f"taps={taps}, K5 takes 1 to {MAX_TAPS}")
        check_tensor(far, "far", torch.float32, (n,), dev)
    for (name, dtype), stage, t in zip(_STATE, _STAGE_OF, state):
        if stages & stage:
            check_tensor(t, name, dtype, (taps,) if name in ("weights", "far_tail") else (), dev)
    if consts.dtype != np.float32 or consts.shape != (len(CAPTURE_CONSTS),):
        raise ValueError(f"consts: {consts.dtype} {consts.shape}, expected "
                         f"float32 ({len(CAPTURE_CONSTS)},)")
    state = tuple(t if stages & stage else None for stage, t in zip(_STAGE_OF, state))
    if new_state is None:
        new_state = tuple(None if t is None else torch.empty_like(t) for t in state)
    if buf is None:
        buf = torch.empty(n + 3, dtype=torch.float32, device=dev)
    check_tensor(buf, "buf", torch.float32, (None,), dev)
    if buf.shape[0] < n + 3:
        raise ValueError(f"buf: {buf.shape[0]} floats, K5 writes {n + 3}")
    with torch.cuda.device(dev):
        CAPTURE_KERNEL(mic.data_ptr(), _ptr(far if stages & STAGE_AEC else None), n, taps,
                       stages, hangover, *map(_ptr, state), consts.ctypes.data,
                       buf.data_ptr(), *map(_ptr, new_state), stream_handle(dev))
    return buf, new_state


def noise_gate(buf, envelope, gate_open, threshold: float = 0.01, attack_s: float = 0.010,
               release_s: float = 0.050, hysteresis: float = 0.9,
               sample_rate: int = SAMPLE_RATE):
    """Noise gate (mixer.c:846-924): the buffer's peak against the threshold
    with hysteresis drives a one-pole envelope that scales each sample.
    buf [N] (any [..., N] on the CPU) -> (out, envelope, gate_open). K5 on a
    CUDA tensor, :func:`noise_gate_reference` on the CPU."""
    if buf.device.type == "cpu":
        return noise_gate_reference(buf, envelope, gate_open, threshold, attack_s,
                                    release_s, hysteresis, sample_rate)
    consts = capture_consts(buf.shape[-1], gate_threshold=threshold, attack_s=attack_s,
                            release_s=release_s, hysteresis=hysteresis,
                            sample_rate=sample_rate)
    state = (None,) * 5 + (envelope, gate_open)
    out, new = capture_launch(STAGE_GATE, buf, None, state, consts)
    return out[:buf.shape[-1]], new[5], new[6]


def highpass(buf, prev_in, prev_out, alpha):
    """One-pole highpass y[n] = alpha * (y[n-1] + x[n] - x[n-1])
    (mixer.c:953-965): buf [N] (any [..., N] on the CPU) -> (out, prev_in,
    prev_out). K5 on a CUDA tensor, :func:`highpass_reference` on the CPU."""
    if buf.device.type == "cpu":
        return highpass_reference(buf, prev_in, prev_out, alpha)
    consts = capture_consts(buf.shape[-1], hp_alpha=float(alpha))
    state = (None,) * 3 + (prev_in, prev_out) + (None,) * 2
    out, new = capture_launch(STAGE_HIGHPASS, buf, None, state, consts)
    return out[:buf.shape[-1]], new[3], new[4]


def echo_cancel(mic, far, weights, far_tail, hang, taps: int = 256, mu: float = 0.5,
                geigel_t: float = 0.5, hangover: int = 1440):
    """NLMS echo cancellation with a Geigel double-talk freeze
    (:func:`echo_cancel_reference` says what it computes): mic, far [N] ->
    (out [N], weights, far_tail, hang, stats [3]). K5 on a CUDA tensor."""
    if mic.device.type == "cpu":
        return echo_cancel_reference(mic, far, weights, far_tail, hang, taps, mu, geigel_t,
                                     hangover)
    n = mic.shape[0]
    consts = capture_consts(n, mu=mu, geigel_t=geigel_t)
    state = (weights, far_tail, hang) + (None,) * 4
    buf, new = capture_launch(STAGE_AEC, mic, far, state, consts, taps, hangover)
    return buf[:n], new[0], new[1], new[2], buf[n:n + 3]


def capture_chain(mic, far, weights, far_tail, hang, hp_in, hp_out, gate_env, gate_open,
                  hp_alpha, *, use_aec: bool, taps: int, mu: float, geigel_t: float,
                  hangover: int, gate_threshold: float):
    """The client's capture chain on one frame, the counterpart of
    ``_client_pipeline_step`` (audio.py:474-494): echo cancellation (when
    ``use_aec``), highpass, noise gate. One K5 launch on a CUDA tensor,
    :func:`capture_chain_reference` on the CPU. Returns (out, weights,
    far_tail, hang, hp_in, hp_out, gate_env, gate_open, stats); without the
    AEC its state passes through and the stats are zeros."""
    args = dict(use_aec=use_aec, taps=taps, mu=mu, geigel_t=geigel_t, hangover=hangover,
                gate_threshold=gate_threshold)
    state = (weights, far_tail, hang, hp_in, hp_out, gate_env, gate_open)
    if mic.device.type == "cpu":
        return capture_chain_reference(mic, far, *state, hp_alpha, **args)
    n = mic.shape[0]
    buf, new = _capture_chain_cuda(mic, far, state, hp_alpha, **args)
    return (buf[:n], *new, buf[n:n + 3])


def _capture_chain_cuda(mic, far, state: tuple, hp_alpha, *, use_aec: bool, taps: int,
                        mu: float, geigel_t: float, hangover: int, gate_threshold: float,
                        buf=None, new_state: tuple | None = None):
    """:func:`capture_chain`'s one K5 launch -> (buf [N + 3], new state);
    without the AEC its state passes through."""
    stages = STAGE_HIGHPASS | STAGE_GATE | (STAGE_AEC if use_aec else 0)
    consts = capture_consts(mic.shape[0], mu=mu, geigel_t=geigel_t, hp_alpha=float(hp_alpha),
                            gate_threshold=gate_threshold)
    buf, new = capture_launch(stages, mic, far, state, consts, taps if use_aec else 0,
                              hangover, buf=buf, new_state=new_state)
    return buf, (new if use_aec else state[:3] + new[3:])


class EchoCanceller:
    """Stateful per-tick echo cancellation (client pipeline): NLMS with the
    Geigel double-talk freeze (:func:`echo_cancel`) and frame-level
    divergence control (here), its state on ``device``
    (``runtime/device.default_device()`` when None)."""

    def __init__(self, taps: int = 256, mu: float = 0.5, geigel_t: float = 0.5,
                 hangover: int = 1440, device: torch.device | str | None = None):
        self.device = default_device() if device is None else torch.device(device)
        self.taps = taps
        self.mu = mu
        self.geigel_t = geigel_t
        self.hangover = hangover
        self.weights = torch.zeros(taps, dtype=torch.float32, device=self.device)
        self.far_tail = torch.zeros(taps, dtype=torch.float32, device=self.device)
        self.hang = torch.zeros((), dtype=torch.int32, device=self.device)
        self.double_talk_frac = 0.0  # last frame's frozen-sample fraction
        self.divergence_resets = 0

    def process(self, mic, far) -> torch.Tensor:
        def on_device(a):
            return torch.from_numpy(np.array(a, np.float32).ravel()).to(self.device)

        out, self.weights, self.far_tail, self.hang, stats = echo_cancel(
            on_device(mic), on_device(far), self.weights, self.far_tail, self.hang,
            taps=self.taps, mu=self.mu, geigel_t=self.geigel_t, hangover=self.hangover)
        dt_frac, out_e, mic_e = stats.tolist()  # one fetch for the frame's telemetry
        self.double_talk_frac = dt_frac
        self.apply_divergence_control(out_e, mic_e)
        return out

    def apply_divergence_control(self, out_e: float, mic_e: float) -> bool:
        """A healthy canceller removes energy; a residual well above the mic
        means the echo model is wrong (the path changed, or it froze
        mid-adaptation): halve the weights, in place, which bounds the output
        and keeps the echo path's shape (audio.py:456-464). Returns whether
        it halved them."""
        if out_e > 2.0 * mic_e + 1e-9:
            self.weights.mul_(0.5)
            self.divergence_resets += 1
            return True
        return False


class _CardIO:
    """The pinned host buffers, device buffers, stream and event of a
    pipeline on a card, for frames of up to ``cap`` samples."""

    def __init__(self, device: torch.device, cap: int):
        self.cap = cap
        self.host_in = torch.empty(2 * cap, dtype=torch.float32, pin_memory=True)
        self.host_out = torch.empty(cap + 3, dtype=torch.float32, pin_memory=True)
        self.host_in_np = self.host_in.numpy()
        self.host_out_np = self.host_out.numpy()
        with torch.cuda.device(device):
            self.dev_in = torch.empty(2 * cap, dtype=torch.float32, device=device)
            self.dev_out = torch.empty(cap + 3, dtype=torch.float32, device=device)
            self.stream = torch.cuda.Stream(device)
            self.done = torch.cuda.Event()


class ClientAudioPipeline:
    """Stateful per-client capture chain (src/client/audio.c:276 capture
    path): AEC first (the echo estimate must see the raw mic), then the
    highpass, then the gate (client_pipeline.cpp: AEC3 -> filters -> gate).

    The state lives on ``device`` (``runtime/device.default_device()`` when
    None: the card, unless ASCIICHAT_TORCH_DEVICE=cpu). On a card each frame
    is one host-to-device copy of the mic and far-end samples from pinned
    memory, one K5 launch that updates the state in place, and one
    device-to-host copy of the output and the AEC's stats, on a stream of the
    pipeline's own; on the CPU it runs the plain versions."""

    def __init__(self, use_aec: bool = True, gate_threshold: float = 0.01,
                 highpass_hz: float = 100.0, device: torch.device | str | None = None):
        self.device = default_device() if device is None else torch.device(device)
        self.aec = EchoCanceller(device=self.device) if use_aec else None
        self.gate_threshold = gate_threshold
        self.hp_alpha = highpass_alpha(highpass_hz)  # (mixer.c:953)

        def zero(dtype):
            return torch.zeros((), dtype=dtype, device=self.device)

        self.hp_in = zero(torch.float32)
        self.hp_out = zero(torch.float32)
        self.gate_env = zero(torch.float32)
        self.gate_open = zero(torch.bool)
        # far-end FIFO of whole chunks, bounded to 1 s, drop-oldest: the far
        # reference must stay aligned to the most recent playback. add_far
        # runs on the receive (event-loop) thread while process runs in the
        # capture executor, so both hold the lock.
        self._far_chunks: collections.deque = collections.deque()
        self._far_len = 0
        self._far_lock = threading.Lock()
        self._io: _CardIO | None = None

    def add_far(self, buf: np.ndarray) -> None:
        """Feed received playback audio as the AEC far-end reference; bounded
        to 1 s so a stalled playback path cannot grow it without limit."""
        chunk = np.asarray(buf, np.float32).ravel()
        if not len(chunk):
            return
        with self._far_lock:
            self._far_chunks.append(chunk)
            self._far_len += len(chunk)
            while (self._far_chunks
                   and self._far_len - len(self._far_chunks[0]) >= SAMPLE_RATE):
                self._far_len -= len(self._far_chunks.popleft())

    def _take_far(self, n: int) -> np.ndarray:
        """Pop n far-end samples FIFO, zero-padded on underrun: consuming what
        exists keeps the reference causally aligned (padding without
        consuming would shift it a frame behind the mic for good)."""
        out = np.zeros(n, np.float32)
        at = 0
        with self._far_lock:
            while at < n and self._far_chunks:
                head = self._far_chunks[0]
                take = min(n - at, len(head))
                out[at: at + take] = head[:take]
                at += take
                if take == len(head):
                    self._far_chunks.popleft()
                else:
                    self._far_chunks[0] = head[take:]
                self._far_len -= take
        return out

    def _state(self) -> tuple:
        aec = self.aec
        if aec is None:
            empty = torch.zeros(0, dtype=torch.float32, device=self.device)
            head = (empty, empty, torch.zeros((), dtype=torch.int32, device=self.device))
        else:
            head = (aec.weights, aec.far_tail, aec.hang)
        return head + (self.hp_in, self.hp_out, self.gate_env, self.gate_open)

    def _chain_args(self) -> dict:
        aec = self.aec
        if aec is None:
            return dict(use_aec=False, taps=1, mu=0.0, geigel_t=0.0, hangover=0,
                        gate_threshold=self.gate_threshold)
        return dict(use_aec=True, taps=aec.taps, mu=aec.mu, geigel_t=aec.geigel_t,
                    hangover=aec.hangover, gate_threshold=self.gate_threshold)

    def _process_card(self, mic: np.ndarray, far: np.ndarray) -> tuple[np.ndarray, list]:
        n = len(mic)
        if self._io is None or self._io.cap < n:
            self._io = _CardIO(self.device, n)
        io = self._io
        io.host_in_np[:n] = mic
        io.host_in_np[n:2 * n] = far
        state = self._state()
        with torch.cuda.device(self.device), torch.cuda.stream(io.stream):
            # state written on the default stream (the zeros made at
            # construction, a state loaded since) lands before the launch
            io.stream.wait_stream(torch.cuda.default_stream(self.device))
            io.dev_in[:2 * n].copy_(io.host_in[:2 * n], non_blocking=True)
            # the new state over the old: K5 reads all of it before it writes
            _capture_chain_cuda(io.dev_in[:n], io.dev_in[n:2 * n], state, self.hp_alpha,
                                **self._chain_args(), buf=io.dev_out, new_state=state)
            io.host_out[:n + 3].copy_(io.dev_out[:n + 3], non_blocking=True)
            io.done.record(io.stream)
        io.done.synchronize()
        return io.host_out_np[:n].copy(), io.host_out_np[n:n + 3].tolist()

    def _process_plain(self, mic: np.ndarray, far: np.ndarray) -> tuple[np.ndarray, list]:
        (out, w, ft, hg, self.hp_in, self.hp_out, self.gate_env, self.gate_open,
         stats) = capture_chain_reference(torch.from_numpy(mic), torch.from_numpy(far),
                                          *self._state(), self.hp_alpha,
                                          **self._chain_args())
        if self.aec is not None:
            self.aec.weights, self.aec.far_tail, self.aec.hang = w, ft, hg
        return out.numpy(), stats.tolist()

    def process(self, mic: np.ndarray) -> np.ndarray:
        """One captured frame -> the processed frame (float32 numpy)."""
        mic = np.array(mic, np.float32).ravel()
        aec = self.aec
        # underruns zero-pad AFTER consuming what exists (see _take_far)
        far = self._take_far(len(mic)) if aec is not None else np.zeros(len(mic), np.float32)
        if self.device.type == "cpu":
            out, stats = self._process_plain(mic, far)
        else:
            out, stats = self._process_card(mic, far)
        if aec is not None:
            aec.double_talk_frac = stats[0]
            if self.device.type == "cpu":
                aec.apply_divergence_control(stats[1], stats[2])
            else:  # on the pipeline's stream, and done before the frame returns
                io = self._io
                with torch.cuda.device(self.device), torch.cuda.stream(io.stream):
                    if aec.apply_divergence_control(stats[1], stats[2]):
                        io.done.record(io.stream)
                        io.done.synchronize()
        return out
