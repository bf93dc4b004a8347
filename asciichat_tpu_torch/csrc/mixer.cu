// K4: the server's exclude-self audio mixer, one whole tick in one launch.
//
// Replaces the XLA graph asciichat_tpu/ops/audio.py::mixer_process
// (audio.py:155-244): a lax.scan over 256-sample frames (MIXER_FRAME_SIZE)
// that carries per-source envelope and ducking gain and per-listener
// compressor state, with per-source and per-listener reductions inside each
// step. In plain PyTorch that scan is ~40 small ops per frame.
//
// Bound: a 10 ms tick of 9 sources moves ~35 KB (17.3 KB of samples in, 17.3
// KB of mixes out, 4 state vectors in and out), ~0.01 us at 3.35 TB/s, and
// does a few tens of thousands of flops. Neither bounds it: what limits the
// kernel is latency on one SM. The scan is serial (each frame's gains depend
// on the last frame's state), the tick's data arrives after one round trip
// to memory, the soft clip's tanhf runs on one SM's instruction slots, and the
// launch itself costs about a microsecond (tools/k4_stages.py times each
// stage; PERF.md holds the numbers).
//
// Design: the scan splits into parallel work and two short serial scans. The
// source side (envelope, speaking gate, ducking gain, crowd gain:
// audio.py:180-194, 211-221) depends only on the peaks of the input frames
// and the carried state; the compressor (:224-229) only on the peaks of the
// mixes. Within each side only the envelope and the gain smoothers chain
// from frame to frame (a few flops each); the transcendentals (log10f,
// powf) and the warp reductions of a frame depend on that frame's envelope
// alone. One CTA of 512 threads walks the tick in windows of up to 16 frames,
// as many as fit in ~200 KB of shared memory (all of a 10 ms tick at any
// source count):
//  1. cp.async copies every source's frames of the window into dynamic shared
//     memory, 16 bytes a copy where the rows are 16-byte aligned, zero-filling
//     past n (audio.py:171-173); the first copy starts before the activity
//     and the state are read, and the next window loads while one is computed;
//  2. one half-warp per (source, frame) masks the frame by `active` (:178)
//     and reduces its peak; each lane reads only what it copied, so no
//     barrier waits for the load;
//  3. warp f takes frame f, lane s source s: it runs the envelope up to its
//     frame, then the frame's speaking count (a ballot), max(env_db) (a
//     shuffle), ducking target and crowd gains; then warp 0 scans the ducking
//     gain over the window's frames;
//  4. one thread per sample forms the full mix and each listener's mix, in
//     place (a thread reads and writes its own column only);
//  5. one half-warp per (listener, frame) reduces the mix peaks;
//  6. warp f runs listener c's compressor envelope up to frame f in lane c and
//     that frame's gain target; warp 0 then scans the compressor gain;
//  7. one thread per sample writes its listeners' soft-clipped outputs,
//     coalesced.
// That is seven block barriers per window, an eighth between windows, where a
// scan that walks the frames one by one needs five per frame. Every element
// keeps the reference's operation order (mixer_math.cuh; the sum over
// sources ascends) and maxima are exact in any order, so the schedule does
// not change a bit of the result. With no active source the tick is silence
// and the state is copied unchanged (audio.py:236-243), decided by one
// barrier vote while the first copy is in flight.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>

#include "mixer_math.cuh"

namespace {

constexpr int kFrame = 256;       // MIXER_FRAME_SIZE (mixer.h:114)
constexpr int kMaxSources = 32;   // one warp lane per source or listener
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHalves = kThreads / 16;  // half-warps
constexpr int kMaxWindow = 16;    // frames per window: one per warp
constexpr int64_t kWindowBytes = 200 * 1024;  // shared memory for the windows
constexpr int kStaticSmemMax = 48 * 1024;     // dynamic size without opt-in
constexpr unsigned kAll = 0xffffffffu;
static_assert(kMaxWindow <= kWarps, "one warp per frame of a window");

// the smaller of two counts (frames or samples), as an int
__device__ __forceinline__ int count_min(int64_t a, int64_t b) {
  return (int)(a < b ? a : b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// The max over the 16 lanes of each half of the warp.
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// The k-th (k < 16) of the 16 samples of a frame that lane h of a half-warp
// copies in and reduces: four runs of 4 with 16-byte copies (V = 4), one
// sample in 16 with 4-byte copies (V = 1).
template <int V>
__device__ __forceinline__ int lane_sample(int h, int k) {
  return V == 4 ? (k >> 2) * 64 + h * 4 + (k & 3) : k * 16 + h;
}

// Starts the copy of frames [f0, f0 + fw) of every source into buf (row
// stride ld floats), one half-warp per (source, frame); past n it fills
// zeros.
template <int V>
__device__ void load_window(float* buf, int ld, const float* samples,
                            int sources, int64_t n, int64_t f0, int fw) {
  const int h = threadIdx.x & 15, half = threadIdx.x >> 4;
  for (int p = half; p < sources * fw; p += kHalves) {
    const int s = p / fw, fl = p % fw;
    const float* row = samples + s * n;
    const int64_t base = (f0 + fl) * kFrame;
    float* dst = buf + s * ld + fl * kFrame;
    for (int k = 0; k < 16; k += V) {
      const int j = lane_sample<V>(h, k);
      const bool in = base + j < n;  // with V = 4, n % 4 == 0: all or none
      __pipeline_memcpy_async(dst + j, in ? row + base + j : row, 4 * V,
                              in ? 0 : 4 * V);
    }
  }
  __pipeline_commit();
}

// peak[fl][r] = max |buf row r, frame fl| for r < rows, fl < fw, one
// half-warp per pair over the samples its lanes copied (the two halves of a
// warp loop together, so both join every shuffle). With kMask the samples
// are first multiplied by their source's activity and written back
// (audio.py:178).
template <int V, bool kMask>
__device__ void frame_peaks(float* buf, int ld, int rows, int fw,
                            const float* act, float (*peak)[kMaxSources]) {
  const int h = threadIdx.x & 15, half = threadIdx.x >> 4;
  for (int p0 = half & ~1; p0 < rows * fw; p0 += kHalves) {
    const int p = p0 + (half & 1), r = p / fw, fl = p % fw;
    float m = 0.0f;
    if (p < rows * fw) {
      float* x = buf + r * ld + fl * kFrame;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = lane_sample<V>(h, k);
        float v = x[j];
        if (kMask) x[j] = v = mx::mul(v, act[r]);
        m = fmaxf(m, fabsf(v));
      }
    }
    m = half_max(m);
    if (h == 0 && p < rows * fw) peak[fl][r] = m;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    mixer_kernel(const float* __restrict__ samples,
                 const uint8_t* __restrict__ active, int sources, int64_t n,
                 int wf, int64_t windows, int nbuf,
                 const float* __restrict__ env_in,
                 const float* __restrict__ duck_in,
                 const float* __restrict__ comp_env_in,
                 const float* __restrict__ comp_gain_in, int exclude_self,
                 const mx::MixerConsts k, float* __restrict__ out,
                 float* __restrict__ env_out, float* __restrict__ duck_out,
                 float* __restrict__ comp_env_out,
                 float* __restrict__ comp_gain_out) {
  extern __shared__ __align__(16) float smem[];  // nbuf windows [sources][ld]
  // per frame of the window and source (or listener); two change role once
  // their scan has read them
  __shared__ float peak[kMaxWindow][kMaxSources];   // input, then mix peaks
  __shared__ float gain[kMaxWindow][kMaxSources];   // ducking target, then
                                                    // duck_gain * active
  __shared__ float crowd[kMaxWindow][kMaxSources];  // base_gain * crowd
  __shared__ float comp[kMaxWindow][kMaxSources];   // compressor target, then
                                                    // its smoothed gain
  // the state carried from window to window, and the envelopes at the end
  // of the window, per source or listener
  __shared__ float act[kMaxSources];  // 1.0 active, 0.0 not
  __shared__ float env[kMaxSources], duck[kMaxSources];
  __shared__ float comp_env[kMaxSources], comp_gain[kMaxSources];
  __shared__ float env_end[kMaxSources], comp_env_end[kMaxSources];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int clients = exclude_self ? sources : 1;
  const int ld = wf * kFrame;
  const int64_t frames = (n + kFrame - 1) / kFrame;

  // 1. the first window's copy starts before anything else is read, so the
  // loads of the activity and the state wait out the same latency
  if (windows > 0)
    load_window<V>(smem, ld, samples, sources, n, 0, count_min(wf, frames));
  bool on = false;
  if (t < sources) {
    on = active[t] != 0;
    act[t] = on ? 1.0f : 0.0f;
    env[t] = env_in[t];
    duck[t] = duck_in[t];
  }
  if (t < clients) {
    comp_env[t] = comp_env_in[t];
    comp_gain[t] = comp_gain_in[t];
  }
  if (!__syncthreads_or(on)) {  // silence out, state untouched (mixer.c:509-512)
    __pipeline_wait_prior(0);
    for (int64_t i = t; i < clients * n; i += kThreads) out[i] = 0.0f;
    if (t < sources) {
      env_out[t] = env[t];
      duck_out[t] = duck[t];
    }
    if (t < clients) {
      comp_env_out[t] = comp_env[t];
      comp_gain_out[t] = comp_gain[t];
    }
    return;
  }

  for (int64_t w = 0; w < windows; ++w) {
    const int slot = nbuf == 2 ? (int)(w & 1) : 0;  // nbuf is 1 or 2
    float* buf = smem + slot * sources * ld;
    const int64_t f0 = w * wf;
    const int fw = count_min(wf, frames - f0);
    if (w + 1 < windows) {  // nbuf == 2: the other buffer is free
      load_window<V>(smem + (1 - slot) * sources * ld, ld, samples,
                     sources, n, f0 + wf, count_min(wf, frames - f0 - wf));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }

    // 2. masked frames and their peaks (audio.py:178-181)
    frame_peaks<V, true>(buf, ld, sources, fw, act, peak);
    __syncthreads();

    // 3. the source side (audio.py:182-221), one frame per warp, lane s on
    // source s: the envelope up to the warp's frame (a few flops a frame),
    // then that frame's speaking count (a ballot), max(env_db) (a shuffle),
    // leader test, ducking target and crowd gains, so the log10f and powf of
    // all the window's frames run at once
    if (warp < fw) {
      const bool live = lane < sources, src_on = live && act[lane] != 0.0f;
      float e = live ? env[lane] : 0.0f;
      for (int fl = 0; fl <= warp; ++fl)
        if (src_on)
          e = mx::attack_release(e, peak[fl][lane], k.duck_attack, k.duck_release);
      if (warp == fw - 1 && live) env_end[lane] = e;
      const bool speaking = src_on && e > k.speaking_floor;
      const float count = (float)__popc(__ballot_sync(kAll, speaking));
      const float env_db = live ? mx::linear_to_db(e) : -INFINITY;
      const float max_db = warp_max(env_db);
      const bool is_speaking = env_db > k.duck_threshold_db;
      const bool leader =
          is_speaking && env_db >= mx::sub(max_db, k.duck_margin_db);
      if (live)
        gain[warp][lane] = (is_speaking && !leader) ? k.duck_atten_lin : 1.0f;
      // each listener's crowd gain counts the speakers other than itself
      // (audio.py:211-215); the full mix counts them all (:218-221)
      if (exclude_self && live)
        crowd[warp][lane] =
            mx::crowd_gain(mx::sub(count, speaking ? 1.0f : 0.0f), k);
      else if (!exclude_self && lane == 0)
        crowd[warp][0] = mx::crowd_gain(count, k);
    }
    __syncthreads();
    if (warp == 0 && lane < sources) {  // the ducking gain's scan
      float d = duck[lane];
      for (int fl = 0; fl < fw; ++fl) {
        d = mx::gain_smooth(d, gain[fl][lane], k.duck_attack, k.duck_release);
        gain[fl][lane] = mx::mul(d, act[lane]);
      }
      duck[lane] = d;
      env[lane] = env_end[lane];
    }
    __syncthreads();

    // 4. mixes: (full - own) * crowd, in place (audio.py:199-222)
    for (int j = t; j < fw * kFrame; j += kThreads) {
      const int fl = j / kFrame;
      float full = 0.0f;
      for (int s = 0; s < sources; ++s)
        full = mx::add(full, mx::mul(buf[s * ld + j], gain[fl][s]));
      if (exclude_self) {
        for (int c = 0; c < sources; ++c) {
          float* x = buf + c * ld + j;
          *x = mx::mul(mx::sub(full, mx::mul(*x, gain[fl][c])), crowd[fl][c]);
        }
      } else {
        buf[j] = mx::mul(full, crowd[fl][0]);
      }
    }
    __syncthreads();

    // 5. mix peaks
    frame_peaks<V, false>(buf, ld, clients, fw, act, peak);
    __syncthreads();

    // 6. per-listener compression (audio.py:224-229), one frame per warp,
    // lane c on listener c: the envelope up to the warp's frame, then that
    // frame's gain target (log10f, powf); warp 0 then smooths the gains
    if (warp < fw && lane < clients) {
      float e = comp_env[lane];
      for (int fl = 0; fl <= warp; ++fl)
        e = mx::attack_release(e, peak[fl][lane], k.comp_attack, k.comp_release);
      if (warp == fw - 1) comp_env_end[lane] = e;
      const float gr_db = mx::gain_reduction_db(mx::linear_to_db(e), k);
      comp[warp][lane] = mx::db_to_linear(mx::add(gr_db, k.comp_makeup_db));
    }
    __syncthreads();
    if (warp == 0 && lane < clients) {
      float g = comp_gain[lane];
      for (int fl = 0; fl < fw; ++fl)
        comp[fl][lane] = g =
            mx::gain_smooth(g, comp[fl][lane], k.comp_attack, k.comp_release);
      comp_gain[lane] = g;
      comp_env[lane] = comp_env_end[lane];
    }
    __syncthreads();

    // 7. soft-clipped output (audio.py:231), coalesced
    for (int j = t; j < fw * kFrame && f0 * kFrame + j < n; j += kThreads) {
      const int fl = j / kFrame;
      for (int c = 0; c < clients; ++c)
        out[c * n + f0 * kFrame + j] =
            mx::soft_clip(mx::mul(buf[c * ld + j], comp[fl][c]), k);
    }
    if (w + 1 < windows) __syncthreads();  // the load after next reuses buf
  }

  if (t < sources) {
    env_out[t] = env[t];
    duck_out[t] = duck[t];
  }
  if (t < clients) {
    comp_env_out[t] = comp_env[t];
    comp_gain_out[t] = comp_gain[t];
  }
}

// Dynamic shared memory past 48 KB needs an opt-in, made once per kernel and
// device, so that a launch captured into a CUDA graph makes no such call.
template <int V>
cudaError_t opt_in() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  rc = cudaFuncSetAttribute(mixer_kernel<V>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)kWindowBytes);
  if (rc == cudaSuccess) done.fetch_or(bit);
  return rc;
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
  // one window holds the whole tick if it fits; else two buffers take turns
  const int64_t frames = (n + kFrame - 1) / kFrame;
  const int64_t frame_bytes = (int64_t)sources * kFrame * sizeof(float);
  int64_t wf = std::min<int64_t>({frames, kMaxWindow, kWindowBytes / frame_bytes});
  int nbuf = 1;
  if (wf < frames) {
    wf = std::min<int64_t>(kMaxWindow, kWindowBytes / (2 * frame_bytes));
    nbuf = 2;
  }
  wf = std::max<int64_t>(wf, 1);
  const int64_t windows = (frames + wf - 1) / wf;
  const int64_t smem = frames ? nbuf * wf * frame_bytes : 0;
  const bool vec = n % 4 == 0 && ((uintptr_t)samples & 15) == 0;
  auto kernel = vec ? mixer_kernel<4> : mixer_kernel<1>;
  if (smem > kStaticSmemMax) {
    const cudaError_t rc = vec ? opt_in<4>() : opt_in<1>();
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      samples, active, sources, n, (int)wf, windows, nbuf, env, duck, comp_env,
      comp_gain, exclude_self, k, out, env_out, duck_out, comp_env_out,
      comp_gain_out);
  return cudaGetLastError();
}
