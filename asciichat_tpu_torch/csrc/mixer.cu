// K4: the server's exclude-self audio mixer, one whole tick in one launch.
//
// Replaces the XLA graph asciichat_tpu/ops/audio.py::mixer_process
// (audio.py:155-244): a lax.scan over 256-sample frames (MIXER_FRAME_SIZE)
// that carries per-source envelope and ducking gain and per-listener
// compressor state, with per-source and per-listener reductions inside each
// step. In plain PyTorch that scan is ~40 small ops per frame; here it is one
// CTA that loops over the frames in order.
//
// Bound: neither bytes nor operations. A 10 ms tick is S x 480 floats in and
// C x 480 out (a few KB); the cost is the scan's serial dependence (each
// frame's gains depend on the last frame's state) and the block barriers
// inside a frame. Design: one CTA of 256 threads, one thread per sample of a
// frame. The frame of every source sits in shared memory (rows padded to 257
// floats, so lane s reading row s hits its own bank); per-source and
// per-listener state lives in warp 0, one lane each (S <= 32 = MAX_CLIENTS),
// where max(env_db) and the speaking count are warp shuffles and a ballot.
// The mixes overwrite the frame in place: thread t reads and writes column t
// only. Whether any source is active is decided once, before the loop; with
// none, the tick is silence and the state is copied unchanged
// (audio.py:236-243).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mixer_math.cuh"

namespace {

constexpr int kFrame = 256;       // MIXER_FRAME_SIZE (mixer.h:114)
constexpr int kMaxSources = 32;   // one warp lane per source
constexpr int kWarps = kFrame / 32;
constexpr int kStride = kFrame + 1;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// max |rows[r][0:256]| for r < n, valid in warp 0 lane r. Each warp takes a
// 32-sample slice of every row (lane r on row r), then warp 0 folds the eight
// slices. Ends after a barrier, so `rows` may be rewritten by the caller.
__device__ float row_peaks(float (*rows)[kStride], int n,
                           float (*partial)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < n) {
    const float* row = rows[lane] + warp * 32;
    float m = 0.0f;
    for (int j = 0; j < 32; ++j) m = fmaxf(m, fabsf(row[j]));
    partial[warp][lane] = m;
  }
  __syncthreads();
  float peak = 0.0f;
  if (warp == 0 && lane < n)
    for (int w = 0; w < kWarps; ++w) peak = fmaxf(peak, partial[w][lane]);
  return peak;
}

__global__ void __launch_bounds__(kFrame)
    mixer_kernel(const float* __restrict__ samples,
                 const uint8_t* __restrict__ active, int sources, int64_t n,
                 const float* __restrict__ env_in,
                 const float* __restrict__ duck_in,
                 const float* __restrict__ comp_env_in,
                 const float* __restrict__ comp_gain_in, int exclude_self,
                 const mx::MixerConsts k, float* __restrict__ out,
                 float* __restrict__ env_out, float* __restrict__ duck_out,
                 float* __restrict__ comp_env_out,
                 float* __restrict__ comp_gain_out) {
  __shared__ float buf[kMaxSources][kStride];  // frame, then the mixes
  __shared__ float partial[kWarps][32];
  __shared__ float act[kMaxSources];    // 1.0 active, 0.0 not
  __shared__ float gain[kMaxSources];   // duck_gain * active, per source
  __shared__ float crowd[kMaxSources];  // base_gain * crowd, per listener
  __shared__ float comp[kMaxSources];   // compressor gain, per listener

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int clients = exclude_self ? sources : 1;
  bool any_active = false;
  for (int s = 0; s < sources; ++s) any_active |= active[s] != 0;

  if (!any_active) {  // silence out, state untouched (mixer.c:509-512)
    for (int64_t i = t; i < (int64_t)clients * n; i += kFrame) out[i] = 0.0f;
    if (t < sources) {
      env_out[t] = env_in[t];
      duck_out[t] = duck_in[t];
    }
    if (t < clients) {
      comp_env_out[t] = comp_env_in[t];
      comp_gain_out[t] = comp_gain_in[t];
    }
    return;
  }

  // warp 0, lane s: source s's envelope and ducking gain, listener s's
  // compressor envelope and gain
  float env = 0.0f, duck = 0.0f, comp_env = 0.0f, comp_gain = 0.0f;
  if (warp == 0) {
    if (lane < sources) {
      env = env_in[lane];
      duck = duck_in[lane];
      act[lane] = active[lane] ? 1.0f : 0.0f;
    }
    if (lane < clients) {
      comp_env = comp_env_in[lane];
      comp_gain = comp_gain_in[lane];
    }
  }
  __syncthreads();

  const int64_t frames = (n + kFrame - 1) / kFrame;
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t i = f * kFrame + t;
    const bool in = i < n;  // pad samples are 0 (audio.py:171-173)
    for (int s = 0; s < sources; ++s)
      buf[s][t] = mx::mul(in ? samples[s * n + i] : 0.0f, act[s]);
    __syncthreads();

    // envelopes, speaking gate, ducking (audio.py:180-194)
    const float peak = row_peaks(buf, sources, partial);
    if (warp == 0) {
      const bool live = lane < sources;
      const bool on = live && act[lane] != 0.0f;
      if (on) env = mx::attack_release(env, peak, k.duck_attack, k.duck_release);
      const bool speaking = on && env > k.speaking_floor;
      const float count = (float)__popc(__ballot_sync(kAll, speaking));
      const float env_db = live ? mx::linear_to_db(env) : -INFINITY;
      const float max_db = warp_max(env_db);
      const bool is_speaking = env_db > k.duck_threshold_db;
      const bool leader = is_speaking && env_db >= mx::sub(max_db, k.duck_margin_db);
      const float target = (is_speaking && !leader) ? k.duck_atten_lin : 1.0f;
      if (live) {
        duck = mx::gain_smooth(duck, target, k.duck_attack, k.duck_release);
        gain[lane] = mx::mul(duck, act[lane]);
      }
      // each listener's crowd gain counts the speakers other than itself
      // (audio.py:211-216); the full mix counts them all (:218-222)
      if (exclude_self && live)
        crowd[lane] = mx::crowd_gain(mx::sub(count, speaking ? 1.0f : 0.0f), k);
      else if (!exclude_self && lane == 0)
        crowd[0] = mx::crowd_gain(count, k);
    }
    __syncthreads();

    // mixes: (full - own) * crowd, in place in column t (audio.py:199-222)
    float full = 0.0f;
    for (int s = 0; s < sources; ++s) full = mx::add(full, mx::mul(buf[s][t], gain[s]));
    if (exclude_self) {
      for (int c = 0; c < sources; ++c)
        buf[c][t] = mx::mul(mx::sub(full, mx::mul(buf[c][t], gain[c])), crowd[c]);
    } else {
      buf[0][t] = mx::mul(full, crowd[0]);
    }
    __syncthreads();

    // per-listener compression (audio.py:225-229)
    const float frame_peak = row_peaks(buf, clients, partial);
    if (warp == 0 && lane < clients) {
      comp_env = mx::attack_release(comp_env, frame_peak, k.comp_attack,
                                    k.comp_release);
      const float gr_db = mx::gain_reduction_db(mx::linear_to_db(comp_env), k);
      const float target = mx::db_to_linear(mx::add(gr_db, k.comp_makeup_db));
      comp_gain = mx::gain_smooth(comp_gain, target, k.comp_attack, k.comp_release);
      comp[lane] = comp_gain;
    }
    __syncthreads();

    if (in)
      for (int c = 0; c < clients; ++c)
        out[c * n + i] = mx::soft_clip(mx::mul(buf[c][t], comp[c]), k);
    __syncthreads();  // the next frame overwrites buf
  }

  if (warp == 0) {
    if (lane < sources) {
      env_out[lane] = env;
      duck_out[lane] = duck;
    }
    if (lane < clients) {
      comp_env_out[lane] = comp_env;
      comp_gain_out[lane] = comp_gain;
    }
  }
}

}  // namespace

// samples f32 [sources, n], active u8 [sources]; state f32 [sources] x 2 and
// [clients] x 2 with clients = sources (exclude_self) or 1; consts_host is a
// host array of the MixerConsts floats, passed to the kernel by value.
extern "C" int ac_mixer(const float* samples, const uint8_t* active,
                        int sources, int64_t n, const float* env,
                        const float* duck, const float* comp_env,
                        const float* comp_gain, int exclude_self,
                        const float* consts_host, float* out, float* env_out,
                        float* duck_out, float* comp_env_out,
                        float* comp_gain_out, void* stream) {
  if (sources < 1 || sources > kMaxSources || n < 0) return cudaErrorInvalidValue;
  mx::MixerConsts k;
  memcpy(&k, consts_host, sizeof(k));
  mixer_kernel<<<1, kFrame, 0, (cudaStream_t)stream>>>(
      samples, active, sources, n, env, duck, comp_env, comp_gain,
      exclude_self, k, out, env_out, duck_out, comp_env_out, comp_gain_out);
  return cudaGetLastError();
}
