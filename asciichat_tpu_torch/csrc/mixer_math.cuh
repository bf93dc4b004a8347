// Scalar math of the exclude-self audio mixer, shared by K4 (mixer.cu) and by
// a g++-built CPU test library (mixer_math_host.cpp), so the CPU tests check
// the formulas the card runs against the JAX package's
// (asciichat_tpu/ops/audio.py:40-152).
//
// Float parity with the reference is decided at three comparisons: the
// speaking gate (env > db_to_linear(-60)), ducking leadership
// (env_db >= max_db - margin) and the smoothers' direction (target > value).
// So every constant arrives precomputed in float32 (MixerConsts, built on the
// host as JAX's weak typing builds it), the operation order is the
// reference's, and products and sums round separately: nvcc would otherwise
// contract a*b + c into one fma, which rounds once where the reference rounds
// twice. powf, log10f and tanhf are the accurate versions (no fast math).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define MX_HD __host__ __device__ __forceinline__
#else
#define MX_HD inline
#endif

namespace mx {

// The mixer's parameters as float32, in this order (asciichat_tpu_torch/ops/
// audio.py MIXER_CONSTS builds the same list from a MixerParams).
struct MixerConsts {
  float duck_attack;        // _coeff(duck_attack_s): exp(-1/(tau*sr))
  float duck_release;
  float comp_attack;
  float comp_release;
  float speaking_floor;     // db_to_linear(-60): the speaking gate
  float duck_threshold_db;  // -45
  float duck_margin_db;     // 6
  float duck_atten_lin;     // db_to_linear(duck_atten_db)
  float comp_threshold_db;  // -10
  float comp_half_knee;     // knee * 0.5
  float comp_slope;         // 1/ratio - 1
  float comp_two_knee;      // 2 * knee
  float comp_makeup_db;
  float crowd_alpha;
  float base_gain;
  float clip_threshold;     // 0.7
  float clip_hi_scale;      // 1 - threshold
  float clip_lo_scale;      // -1 + threshold (the reference's sign defect)
  float clip_steepness;     // 3
};

// Separately rounded float operations (round to nearest even).
MX_HD float mul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

MX_HD float add(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

MX_HD float sub(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// 10^(db/20) (audio.py:40).
MX_HD float db_to_linear(float db) { return powf(10.0f, db / 20.0f); }

// 20 log10(max(x, 1e-12)) (audio.py:44).
MX_HD float linear_to_db(float x) {
  return mul(20.0f, log10f(fmaxf(x, 1e-12f)));
}

// Envelope smoothing: attack when the level rises (audio.py:142-145).
MX_HD float attack_release(float value, float target, float attack,
                           float release) {
  const float coeff = target > value ? attack : release;
  return add(mul(coeff, value), mul(sub(1.0f, coeff), target));
}

// Gain smoothing: attack when the gain falls (audio.py:148-152).
MX_HD float gain_smooth(float value, float target, float attack,
                        float release) {
  const float coeff = target < value ? attack : release;
  return add(mul(coeff, value), mul(sub(1.0f, coeff), target));
}

// Soft-knee downward compression curve in dB (audio.py:132-139).
MX_HD float gain_reduction_db(float level_db, const MixerConsts& k) {
  const float over = sub(level_db, k.comp_threshold_db);
  if (over <= -k.comp_half_knee) return 0.0f;
  if (over >= k.comp_half_knee) return mul(k.comp_slope, over);
  const float x = add(over, k.comp_half_knee);
  return mul(k.comp_slope, mul(x, x)) / k.comp_two_knee;
}

// One listener's bus gain: base_gain / count^alpha over `count` speakers,
// 1 with none (audio.py:212-222).
MX_HD float crowd_gain(float count, const MixerConsts& k) {
  const float crowd =
      count > 0.0f ? 1.0f / powf(fmaxf(count, 1.0f), k.crowd_alpha) : 1.0f;
  return mul(k.base_gain, crowd);
}

// tanh knee above +-threshold, with the reference's non-monotonic negative
// branch kept on purpose (audio.py:115-129).
MX_HD float soft_clip(float x, const MixerConsts& k) {
  if (x > k.clip_threshold)
    return add(k.clip_threshold,
               mul(k.clip_hi_scale,
                   tanhf(mul(sub(x, k.clip_threshold), k.clip_steepness))));
  if (x < -k.clip_threshold)
    return add(-k.clip_threshold,
               mul(k.clip_lo_scale,
                   tanhf(mul(add(x, k.clip_threshold), k.clip_steepness))));
  return x;
}

}  // namespace mx
