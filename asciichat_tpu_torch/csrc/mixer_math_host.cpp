// CPU test library over mixer_math.cuh: the mixer's scalar functions that K4
// runs, compiled by g++ and applied to float32 arrays, so a test can check
// them against the JAX package's over dense grids. Built by
// runtime/kernel_build.mixer_math_lib(); not used at run time.
#include <stdint.h>

#include "mixer_math.cuh"

namespace {

mx::MixerConsts consts_from(const float* p) {
  mx::MixerConsts k;
  float* dst = reinterpret_cast<float*>(&k);
  for (unsigned i = 0; i < sizeof(k) / sizeof(float); ++i) dst[i] = p[i];
  return k;
}

}  // namespace

extern "C" {

int mm_consts_count() { return (int)(sizeof(mx::MixerConsts) / sizeof(float)); }

void mm_db_to_linear(const float* x, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = mx::db_to_linear(x[i]);
}

void mm_linear_to_db(const float* x, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = mx::linear_to_db(x[i]);
}

void mm_attack_release(const float* value, const float* target, int64_t n,
                       float attack, float release, float* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = mx::attack_release(value[i], target[i], attack, release);
}

void mm_gain_smooth(const float* value, const float* target, int64_t n,
                    float attack, float release, float* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = mx::gain_smooth(value[i], target[i], attack, release);
}

void mm_gain_reduction_db(const float* level_db, int64_t n,
                          const float* consts, float* out) {
  const mx::MixerConsts k = consts_from(consts);
  for (int64_t i = 0; i < n; ++i) out[i] = mx::gain_reduction_db(level_db[i], k);
}

void mm_crowd_gain(const float* count, int64_t n, const float* consts,
                   float* out) {
  const mx::MixerConsts k = consts_from(consts);
  for (int64_t i = 0; i < n; ++i) out[i] = mx::crowd_gain(count[i], k);
}

void mm_soft_clip(const float* x, int64_t n, const float* consts, float* out) {
  const mx::MixerConsts k = consts_from(consts);
  for (int64_t i = 0; i < n; ++i) out[i] = mx::soft_clip(x[i], k);
}

}  // extern "C"
