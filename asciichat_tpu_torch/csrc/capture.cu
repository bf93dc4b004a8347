// K5: the client's capture chain, one audio frame in one launch.
//
// Replaces the XLA graph asciichat_tpu/ops/audio.py::_client_pipeline_step
// (audio.py:474-494), which the client runs on every 10 ms frame of 480
// samples before it sends it: echo_cancel (:379-421), an NLMS filter of 256
// taps over the far-end (speaker) signal with a Geigel double-talk freeze and
// a hangover, as a scan over the samples; then highpass (:285-295), a
// one-pole filter; then noise_gate (:251-278), a gated envelope.
//
// Bound: at 256 taps and 480 samples a frame moves ~10 KB (mic, far, the
// weights and the far tail in; the output, the stats, the weights and the
// tail out) and does ~1 M float operations (per sample and tap: a
// multiply-add each for w.x and x.x, a max, and the update's multiply, divide
// and add): ~15 ns at the card's float32 peak, ~3 ns at its memory rate.
// Neither bounds it: the scan is a chain of 480 dependent steps (each
// sample's error needs the weights that the last sample updated), so it is
// bound by the latency of one step, on one SM.
//
// Design: one CTA of one warp. Lane l holds taps l, l+32, ..., of the weights
// in registers (taps <= 32 K). The far history (the old tail, then the frame's
// far samples) and the mic frame are in shared memory, loaded once; sample i's
// window is history[i+1, i+taps], so the lanes read consecutive words and no
// bank conflicts. Per sample each lane forms its partial w.x, max|x| and x.x,
// and one xor butterfly of 5 rounds reduces the three together: every lane then
// holds the same y, peak and norm (each add of the butterfly is commutative),
// so no barrier is needed. The Geigel test and the hangover are exact (a max
// does not depend on order). The weight update is lane-local, w += ((adapt *
// mu) * e) * x / norm in that order, each quotient the IEEE one from one
// reciprocal a sample (quot_by: a division per tap, a subroutine with a range
// check and a branch, made the first build several times slower). Every lane
// runs the highpass on each e as it comes out and tracks the peak of its output
// (the gate decides on the whole buffer's peak, audio.py:264, so the gate scan
// runs after the NLMS loop). Lane i % 32 keeps sample i in a register, and
// every 32 samples all lanes store theirs at once; the gate's serial scan runs
// in every lane after the loop and lane i % 32 writes sample i, so no lane
// reads shared memory that another lane wrote after the one barrier, which
// follows the loads. The stats (frozen fraction, residual and mic energies) are
// written after the output in the same buffer, so the host fetches both with
// one copy.
//
// Rounding: w.x and x.x sum in another order than the plain version (within
// rtol=2e-4, atol=2e-5 of it); every other step rounds as the plain version and
// the JAX package's XLA code do: products, sums and quotients round separately
// (explicit __fmul_rn / __fadd_rn / __fsub_rn, and quotients correctly rounded,
// so nvcc contracts nothing), except the gate's envelope update, which XLA
// fuses into one multiply-add (__fmaf_rn). The frozen fraction is the count
// times float32(1/N), as jnp.mean computes it. With the AEC off the output is
// bit for bit the plain version's.
//
// The kernel reads all of its input state before it writes any, so the new
// state may overwrite the old in place.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxTaps = 1024;     // 32 weights a lane
constexpr int kMaxSamples = 3072;  // history + mic + values within 48 KB
constexpr unsigned kAll = 0xffffffffu;
constexpr int kStageAec = 1, kStageHighpass = 2, kStageGate = 4;

// The chain's float32 parameters, in this order (asciichat_tpu_torch/ops/
// audio.py CAPTURE_CONSTS builds the same list).
struct CaptureConsts {
  float mu;                   // NLMS step
  float geigel_t;             // double talk when |mic| > geigel_t * max|x|
  float norm_eps;             // 1e-6 added to x.x
  float hp_alpha;             // highpass pole
  float gate_threshold;       // the gate's threshold while closed
  float gate_threshold_open;  // threshold * hysteresis, while open
  float gate_attack;          // 1 - exp(-1/(attack_s * sr))
  float gate_release;
  float inv_n;                // float32(1/N)
};

// Separately rounded float operations (round to nearest even), and the one
// fused multiply-add.
__device__ __forceinline__ float mul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float add(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__device__ __forceinline__ float sub(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

__device__ __forceinline__ float quot(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

__device__ __forceinline__ float fused(float a, float b, float c) {  // a*b + c
#if defined(__CUDA_ARCH__)
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

// a / b correctly rounded, given y = 1/b correctly rounded: q = a y is
// within an ulp of a/b, the residual a - q b is exact in one fma, and one
// more fma rounds q + (a - q b) y to the IEEE quotient (Markstein's
// theorem; the operands must stay clear of overflow and underflow, as the
// NLMS update's do). Zero keeps its sign, as a division does. Three
// instructions with no branch, where a division is a subroutine with a
// range check: the update takes a reciprocal per sample and this per tap.
__device__ __forceinline__ float quot_by(float a, float b, float y) {
  const float q = mul(a, y);
  const float r = fused(-q, b, a);
  return a == 0.0f ? a : fused(r, y, q);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

template <int K>  // weights a lane: taps <= 32 K
__global__ void __launch_bounds__(kLanes)
    capture_kernel(const float* __restrict__ mic, const float* __restrict__ far,
                   int n, int taps, int stages, int hangover,
                   const float* weights, const float* far_tail,
                   const int* hang_in, const float* hp_in, const float* hp_out,
                   const float* gate_env, const uint8_t* gate_open,
                   const CaptureConsts c, float* __restrict__ out,
                   float* weights_out, float* far_tail_out, int* hang_out,
                   float* hp_in_out, float* hp_out_out, float* gate_env_out,
                   uint8_t* gate_open_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const bool aec = stages & kStageAec, hp = stages & kStageHighpass,
             gate = stages & kStageGate;
  float* hist = smem;                       // [taps + n]: far tail, then far
  float* mic_s = smem + (aec ? taps + n : 0);  // [n]
  float* vals = mic_s + n;                  // [n]: the gate's input

  // 1. load the frame and all of the state
  float mic_e = 0.0f;  // this lane's part of sum(mic^2)
  for (int i = lane; i < n; i += kLanes) {
    const float m = mic[i];
    mic_s[i] = m;
    mic_e = fused(m, m, mic_e);
  }
  float w[K];
  int hang = 0;
  if (aec) {
    for (int j = lane; j < taps; j += kLanes) hist[j] = far_tail[j];
    for (int i = lane; i < n; i += kLanes) hist[taps + i] = far[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + kLanes * k;
      w[k] = j < taps ? weights[j] : 0.0f;
    }
    hang = *hang_in;
  }
  float pin = hp ? *hp_in : 0.0f, pout = hp ? *hp_out : 0.0f;
  float env = gate ? *gate_env : 0.0f;
  bool is_open = gate && *gate_open != 0;
  __syncwarp();

  // 2. per sample: NLMS (audio.py:396-412), then the highpass (:289-292)
  int frozen = 0;
  float res_e = 0.0f;  // this lane's part of sum(e^2)
  float peak = 0.0f;   // max |gate input|, the same in every lane
  float mine = 0.0f;  // the value of this lane's sample of the last 32
  for (int i = 0; i < n; ++i) {
    const int slot = i & (kLanes - 1);
    float e = mic_s[i];
    if (aec) {
      const float* win = hist + i + 1;  // ends at far[i]: delays 0..taps-1
      float x[K], wx = 0.0f, xmax = 0.0f, xx = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + kLanes * k;
        x[k] = j < taps ? win[j] : 0.0f;
        wx = fused(w[k], x[k], wx);
        xmax = fmaxf(xmax, fabsf(x[k]));
        xx = fused(x[k], x[k], xx);
      }
      for (int o = 16; o > 0; o >>= 1) {
        wx = add(wx, __shfl_xor_sync(kAll, wx, o));
        xmax = fmaxf(xmax, __shfl_xor_sync(kAll, xmax, o));
        xx = add(xx, __shfl_xor_sync(kAll, xx, o));
      }
      const float m = e;
      e = sub(m, wx);
      // Geigel: |mic| against the loudest far sample the echo could stem from
      const bool talk = fabsf(m) > mul(c.geigel_t, xmax);
      hang = talk ? hangover : (hang > 0 ? hang - 1 : 0);
      const float adapt = hang == 0 ? 1.0f : 0.0f;
      frozen += hang != 0;
      const float norm = add(xx, c.norm_eps);
      const float inv_norm = quot(1.0f, norm);
      const float g = mul(mul(adapt, c.mu), e);
#pragma unroll
      for (int k = 0; k < K; ++k)
        w[k] = add(w[k], quot_by(mul(g, x[k]), norm, inv_norm));
      const float mine_e = slot == lane ? e : 0.0f;
      res_e = fused(mine_e, mine_e, res_e);
    }
    if (hp) {
      const float y = mul(c.hp_alpha, sub(add(pout, e), pin));
      pin = e;
      pout = y;
      e = y;
    }
    peak = fmaxf(peak, fabsf(e));
    mine = slot == lane ? e : mine;
    if (slot == kLanes - 1 || i == n - 1) {  // every lane stores its sample
      const int at = i - slot + lane;
      if (at <= i) (gate ? vals : out)[at] = mine;
    }
  }

  // 3. the gate's scan over the frame (audio.py:266-273), literally
  if (gate) {
    float mine_env = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int slot = i & (kLanes - 1);
      const float thr = is_open ? c.gate_threshold_open : c.gate_threshold;
      const float target = peak > thr ? 1.0f : 0.0f;
      is_open = target > 0.5f;
      const float coeff = target > env ? c.gate_attack : c.gate_release;
      env = fused(coeff, sub(target, env), env);
      mine_env = slot == lane ? env : mine_env;
      if (slot == kLanes - 1 || i == n - 1) {
        const int at = i - slot + lane;  // this lane stored vals[at] itself
        if (at <= i) out[at] = mul(vals[at], mine_env);
      }
    }
  }

  // 4. the new state and the stats [frozen fraction, sum(e^2), sum(mic^2)]
  res_e = warp_sum(res_e);
  mic_e = warp_sum(mic_e);
  if (aec) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + kLanes * k;
      if (j < taps) weights_out[j] = w[k];
    }
    for (int j = lane; j < taps; j += kLanes) far_tail_out[j] = hist[n + j];
  }
  if (lane == 0) {
    out[n] = aec ? mul((float)frozen, c.inv_n) : 0.0f;
    out[n + 1] = aec ? res_e : 0.0f;
    out[n + 2] = aec ? mic_e : 0.0f;
    if (aec) *hang_out = hang;
    if (hp) {
      *hp_in_out = pin;
      *hp_out_out = pout;
    }
    if (gate) {
      *gate_env_out = env;
      *gate_open_out = is_open ? 1 : 0;
    }
  }
}

}  // namespace

// mic, far f32 [n] (far read only with the AEC); weights and far_tail f32
// [taps], hang i32, hp_in, hp_out and gate_env f32, gate_open u8 (each read
// and written only if its stage runs: stages is a mask of 1 AEC, 2 highpass,
// 4 gate); consts_host a host array of the CaptureConsts floats, passed by
// value; out f32 [n + 3]. The *_out state may alias the input state.
extern "C" int ac_capture_chain(const float* mic, const float* far, int n,
                                int taps, int stages, int hangover,
                                const float* weights, const float* far_tail,
                                const int* hang, const float* hp_in,
                                const float* hp_out, const float* gate_env,
                                const uint8_t* gate_open,
                                const float* consts_host, float* out,
                                float* weights_out, float* far_tail_out,
                                int* hang_out, float* hp_in_out,
                                float* hp_out_out, float* gate_env_out,
                                uint8_t* gate_open_out, void* stream) {
  const bool aec = stages & kStageAec;
  if (n < 1 || n > kMaxSamples || (stages & ~7) != 0 ||
      (aec && (taps < 1 || taps > kMaxTaps)))
    return cudaErrorInvalidValue;
  CaptureConsts c;
  memcpy(&c, consts_host, sizeof(c));
  const int lanes_taps = aec ? (taps + kLanes - 1) / kLanes : 1;
  const size_t smem = sizeof(float) * ((aec ? taps + n : 0) + 2 * (size_t)n);
  auto kernel = lanes_taps <= 1    ? capture_kernel<1>
                : lanes_taps <= 2  ? capture_kernel<2>
                : lanes_taps <= 4  ? capture_kernel<4>
                : lanes_taps <= 8  ? capture_kernel<8>
                : lanes_taps <= 16 ? capture_kernel<16>
                                   : capture_kernel<32>;
  kernel<<<1, kLanes, smem, (cudaStream_t)stream>>>(
      mic, far, n, taps, stages, hangover, weights, far_tail, hang, hp_in,
      hp_out, gate_env, gate_open, c, out, weights_out, far_tail_out, hang_out,
      hp_in_out, hp_out_out, gate_env_out, gate_open_out);
  return cudaGetLastError();
}
