// K5: the client's capture chain, one audio frame in one launch.
//
// Replaces the XLA graph asciichat_tpu/ops/audio.py::_client_pipeline_step
// (audio.py:474-494), which the client runs on every 10 ms frame of 480
// samples before it sends it: echo_cancel (:379-421), an NLMS filter of 256
// taps over the far-end (speaker) signal with a Geigel double-talk freeze and
// a hangover, as a scan over the samples; then highpass (:285-295), a
// one-pole filter; then noise_gate (:251-278), a gated envelope.
//
// Bound: at 256 taps and 480 samples a frame moves ~10 KB and does ~1 M float
// operations: ~15 ns at the card's float32 peak. Neither bounds it: each
// sample's error needs the weights that the last sample updated, so the
// frame is a chain of 480 dependent steps, on one SM, and the kernel is
// bound by the latency of one step.
//
// Design: one CTA of 8 warps. Only e_i depends on e_{i-1}; everything else
// the NLMS step needs is a function of the input, and the whole CTA computes
// it off the chain.
// 1. Prologue, in parallel over the samples: each window's energy x.x, its
//    peak max|x|, norm = x.x + 1e-6 and its correctly rounded reciprocal, and
//    the Geigel test. The hangover is a scan: hang_i = H - (i - L) after the
//    last double-talk sample L <= i (floored at 0), else hang0 - 1 - i; L is
//    a max-scan over the samples, so adapt_i and the frozen count are exact.
// 2. Blocked look-ahead over blocks of kBlock samples that start with weights
//    w0: y_j = w_j.x_j = w0.x_j + sum_{k<j} c_k (x_k.x_j), c_k = g_k / norm_k,
//    g_k = (adapt_k mu) e_k. Per block: (A) all warps compute p_j = w0.x_j;
//    (S) warp 0 holds sample j's accumulator in lane j (from p_j) and, for
//    each k in turn, lane k forms e_k = m_k - acc_k and c_k, one shuffle
//    broadcasts c_k and every lane does acc += c_k G_kj: a subtract, a
//    multiply, a shuffle and a multiply-add a sample. Meanwhile warps 1-3
//    and 5 build the next block's Gram band G_kj = x_k.x_j (k < j) in shared
//    memory: a direct dot for each lag d from the block's first sample, then
//    G(k, k+d) = G(k-1, k-1+d) + h[k+taps] h[k+taps+d] - h[k] h[k+d] down
//    the block, as a scan over the lanes; warp 4 runs the highpass over the
//    last block's errors, and warps 6-7 the gate's envelope (below). (U)
//    Thread t owns tap t (t + 256 u) and applies the block's updates in
//    order, as the literal scan does: w = w + ((adapt mu) e_k) x_k / norm_k,
//    each quotient the IEEE one from the sample's reciprocal (quot_by).
//    A warp issues in order, so a loop whose step waits on a load or on the
//    last step's result costs that latency every step: the update takes the
//    block's 32 quotients first (independent) and then adds them in order,
//    the highpass loads a block of errors before its chain, and the mat-vec
//    and the Gram band load without branches from a history padded with
//    zeros (tools/k5_variants.py leaves out one part at a time to show where
//    the time goes).
// 3. The gate decides on the whole frame's peak (audio.py:264), so its
//    targets follow from the peak and the gate's state alone: all 1 above
//    both thresholds, all 0 at or below the closed one, and in between
//    (only with hysteresis above 1, where an open gate's threshold is the
//    higher one) 1 and 0 in turn, the gate closing and opening each sample.
//    Its envelope does not depend on the signal: warps 6 and 7 run it toward
//    0 and toward 1 while the rest works, warp 5 (with hysteresis above 1)
//    toward the alternating target after the loop, and once the peak is
//    known every thread multiplies by the right one.
// Without the AEC, warp 4's highpass and the envelopes run at once.
//
// Rounding: y_j comes from the correction form, not from the updated
// weights, and the dot products and energies sum in another order than the
// plain version (within rtol=2e-4, atol=2e-5 of it). Every other step rounds
// as the plain version and the JAX package's XLA code do: products, sums and
// quotients round separately (explicit __fmul_rn / __fadd_rn / __fsub_rn,
// quotients correctly rounded, so nvcc contracts nothing), except the gate's
// envelope update, which XLA fuses into one multiply-add (__fmaf_rn). The
// frozen fraction is the count times float32(1/N), as jnp.mean computes it.
// With the AEC off the output is bit for bit the plain version's; with a
// frozen filter y_j = w0.x_j, a single product at one tap.
//
// The kernel reads all of its input state before it writes any, so the new
// state may overwrite the old in place. The stats (frozen fraction, residual
// and mic energies) follow the output in the same buffer, so the host fetches
// both with one copy.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
constexpr int kBlock = 32;        // samples a block of the look-ahead
static_assert(kBlock >= 2 && kBlock <= kLanes, "a block's samples are a warp's lanes");
constexpr int kMaxTaps = 1024;     // 32 weights a lane in the mat-vec
constexpr int kMaxSamples = 3072;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kStageAec = 1, kStageHighpass = 2, kStageGate = 4;
// the warps' parts while warp 0 runs a block's serial step. Warp w issues
// from scheduler w % 4, so the serial warp shares its scheduler only with
// the highpass warp, one light lane.
constexpr int kGramWarps = 4;  // warps 1, 2, 3 and 5 (5 also the gate's alternating envelope)
constexpr int kHighpassWarp = 4, kEnvWarp = 6;  // warps 6 and 7: envelope toward 0, 1
constexpr int kSmallSmem = 48 * 1024;  // dynamic shared memory without opting in

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

// The zeros after the far history: the mat-vec reads 32 KW taps of a window,
// and the Gram band two blocks past a block's start.
template <int KW>
__host__ __device__ constexpr int history_pad() {
  return kLanes * KW + 2 * kBlock;
}

// The Gram warp index (0 to kGramWarps - 1) of a warp, -1 for another.
__device__ __forceinline__ int gram_index(int warp) {
  return warp >= 1 && warp < kHighpassWarp ? warp - 1 : warp == kHighpassWarp + 1 ? 3 : -1;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// The Gram band of the block of nb samples from s (G[k * kBlock + j] =
// x_{s+k} . x_{s+j}, k < j), by warp gw of kGramWarps, for its lags d = 1 +
// gw + kGramWarps q: a direct dot of the block's first window with window d,
// then, by the sliding window's recurrence, G(k, k+d) = G(0, d) plus the sum
// over k' = 1..k of h[s+k'+taps] h[s+k'+taps+d] - h[s+k'] h[s+k'+d], an
// inclusive scan over the lanes (lane k holding row k).
template <int KW>
__device__ void gram_band(float* G, const float* hist, int s, int nb, int taps, int gw,
                          int lane) {
  // the lags' dots at once, then their butterflies interleaved; lag d
  // down the block as an inclusive scan over the lanes of its window-to-
  // window changes
  constexpr int kLags = (kBlock - 1 + kGramWarps - 1) / kGramWarps;
  const float* x0 = hist + s + 1;
  float acc[kLags], run[kLags];
#pragma unroll
  for (int q = 0; q < kLags; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int k = 0; k < KW; ++k) {  // no branches: every load lies in the padded history
    const int tap = lane + kLanes * k;
    const float x = tap < taps ? x0[tap] : 0.0f;
#pragma unroll
    for (int q = 0; q < kLags; ++q) acc[q] = fused(x, x0[tap + 1 + gw + kGramWarps * q], acc[q]);
  }
  const int i = s + lane;
#pragma unroll
  for (int q = 0; q < kLags; ++q) {
    const int d = 1 + gw + kGramWarps * q;
    const float delta = fused(hist[i + taps], hist[i + taps + d], -mul(hist[i], hist[i + d]));
    run[q] = lane >= 1 && lane + d < nb ? delta : 0.0f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < kLags; ++q) acc[q] = add(acc[q], __shfl_xor_sync(kAll, acc[q], o));
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
#pragma unroll
    for (int q = 0; q < kLags; ++q) {
      const float v = __shfl_up_sync(kAll, run[q], o);
      if (lane >= o) run[q] = add(run[q], v);
    }
  }
#pragma unroll
  for (int q = 0; q < kLags; ++q) {
    const int d = 1 + gw + kGramWarps * q;
    if (lane + d < nb) G[lane * kBlock + lane + d] = add(acc[q], run[q]);
  }
}

template <int KW>  // weights a lane in the mat-vec: taps <= 32 KW
__global__ void __launch_bounds__(kThreads)
    capture_kernel(const float* __restrict__ mic, const float* __restrict__ far,
                   int n, int taps, int stages, int hangover,
                   const float* weights, const float* far_tail,
                   const int* hang_in, const float* hp_in, const float* hp_out,
                   const float* gate_env, const uint8_t* gate_open,
                   const CaptureConsts c, float* __restrict__ out,
                   float* weights_out, float* far_tail_out, int* hang_out,
                   float* hp_in_out, float* hp_out_out, float* gate_env_out,
                   uint8_t* gate_open_out) {
  constexpr int KU = KW < 8 ? 1 : KW / 8;  // taps a thread in the update: taps <= 256 KU
  extern __shared__ float smem[];
  __shared__ float gram[2][kBlock * kBlock];  // this block's band, the next one's
  __shared__ float p_s[kBlock], g_s[kBlock];  // a block's w0.x_j and (adapt mu) e_j
  __shared__ float red_mic[kWarps];
  __shared__ int red_frozen[kWarps], red_last[kWarps];
  __shared__ int hang_s;
  __shared__ float peak_s, res_s, pin_s, pout_s, env_end[3];
  const int t = threadIdx.x, lane = t % kLanes, warp = t / kLanes;
  const bool aec = stages & kStageAec, hp = stages & kStageHighpass,
             gate = stages & kStageGate;
  // with hysteresis above 1 a peak between the thresholds alternates the target
  const bool alternates = gate && c.gate_threshold_open > c.gate_threshold;
  const int envs = gate ? (alternates ? 3 : 2) : 0;
  float* sig = smem;                           // [n]: mic, then e, then the highpass output
  float* env = sig + n;                        // [envs n]: envelope toward 0, 1, alternating
  // [taps + n + pad]: far tail, then far, then zeros that the branch-free
  // loops of the mat-vec and the Gram band may read past a window's end
  float* hist = env + envs * n;
  const int hist_len = aec ? n + history_pad<KW>() : 0;
  float* norm = hist + hist_len;               // [n]: x.x + 1e-6
  float* inv = norm + (aec ? n : 0);           // [n]: 1 / norm
  float* gmu = inv + (aec ? n : 0);            // [n]: double talk, then adapt * mu
  float* w_s = gmu + (aec ? n : 0);            // [taps]: the weights at a block's start

  // 1. load the frame and all of the state
  float mic_e = 0.0f;  // this thread's part of sum(mic^2)
  for (int i = t; i < n; i += kThreads) {
    const float m = mic[i];
    sig[i] = m;
    mic_e = fused(m, m, mic_e);
  }
  float w[KU];
  int hang0 = 0;
  if (aec) {
    for (int j = t; j < taps; j += kThreads) hist[j] = far_tail[j];
    for (int i = t; i < n; i += kThreads) hist[taps + i] = far[i];
    for (int i = taps + n + t; i < hist_len; i += kThreads) hist[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int tap = t + kThreads * u;
      w[u] = tap < taps ? weights[tap] : 0.0f;
      if (tap < taps) w_s[tap] = w[u];
    }
    hang0 = *hang_in;
  }
  float pin = hp ? *hp_in : 0.0f, pout = hp ? *hp_out : 0.0f;
  const float env0 = gate ? *gate_env : 0.0f;
  const bool open0 = gate && *gate_open != 0;
  __syncthreads();

  // 2. the input-only terms of every sample, and the first block's Gram band
  const int blocks = (n + kBlock - 1) / kBlock;
  if (aec) {
    for (int i = t; i < n; i += kThreads) {
      const float* win = hist + i + 1;  // ends at far[i]: delays 0..taps-1
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, xmax = 0.0f;
      int j = 0;
      for (; j + 4 <= taps; j += 4) {
        const float x0 = win[j], x1 = win[j + 1], x2 = win[j + 2], x3 = win[j + 3];
        s0 = fused(x0, x0, s0);
        s1 = fused(x1, x1, s1);
        s2 = fused(x2, x2, s2);
        s3 = fused(x3, x3, s3);
        xmax = fmaxf(fmaxf(xmax, fabsf(x0)), fmaxf(fmaxf(fabsf(x1), fabsf(x2)), fabsf(x3)));
      }
      for (; j < taps; ++j) {
        s0 = fused(win[j], win[j], s0);
        xmax = fmaxf(xmax, fabsf(win[j]));
      }
      norm[i] = add(add(add(s0, s1), add(s2, s3)), c.norm_eps);
      inv[i] = quot(1.0f, norm[i]);
      // Geigel: |mic| against the loudest far sample the echo could stem from
      gmu[i] = fabsf(sig[i]) > mul(c.geigel_t, xmax) ? 1.0f : 0.0f;
    }
    if (gram_index(warp) >= 0)
      gram_band<KW>(gram[0], hist, 0, min(kBlock, n), taps, gram_index(warp), lane);
  }
  __syncthreads();

  // 3. the hangover (audio.py:396-405): thread t scans the samples [lo, hi)
  // for the last double-talk sample, a max-scan across the CTA gives each
  // thread the last one before its range, and each thread then writes its
  // samples' adapt * mu in order
  if (aec) {
    const int per = (n + kThreads - 1) / kThreads;
    const int lo = min(t * per, n), hi = min(lo + per, n);
    int last = -1;
    for (int i = lo; i < hi; ++i)
      if (gmu[i] != 0.0f) last = i;
    int scan = last;  // inclusive across the warp
    for (int o = 1; o < kLanes; o <<= 1) {
      const int v = __shfl_up_sync(kAll, scan, o);
      if (lane >= o) scan = max(scan, v);
    }
    if (lane == kLanes - 1) red_last[warp] = scan;
    const int up = __shfl_up_sync(kAll, scan, 1);
    __syncthreads();
    last = lane == 0 ? -1 : up;
    for (int q = 0; q < warp; ++q) last = max(last, red_last[q]);
    int frozen = 0;
    for (int i = lo; i < hi; ++i) {
      if (gmu[i] != 0.0f) last = i;
      const int h = last >= 0 ? max(hangover - (i - last), 0) : max(hang0 - 1 - i, 0);
      frozen += h != 0;
      gmu[i] = mul(h == 0 ? 1.0f : 0.0f, c.mu);
      if (i == n - 1) hang_s = h;
    }
    frozen = warp_sum(frozen);
    mic_e = warp_sum(mic_e);
    if (lane == 0) {
      red_frozen[warp] = frozen;
      red_mic[warp] = mic_e;
    }
  }

  // the serial lanes' parts: the highpass of samples [lo, hi) (with the
  // residual energy and the peak), and the gate's envelope toward a target
  float res_e = 0.0f, peak = 0.0f;
  auto highpass_step = [&](float e) {
    if (aec) res_e = fused(e, e, res_e);
    if (hp) {
      const float y = mul(c.hp_alpha, sub(add(pout, e), pin));
      pin = e;
      pout = y;
      e = y;
    }
    peak = fmaxf(peak, fabsf(e));
    return e;
  };
  // a block of the AEC's errors: its loads first, then the chain
  auto highpass_block = [&](int lo, int m) {
    float v[kBlock];
#pragma unroll
    for (int k = 0; k < kBlock; ++k) v[k] = sig[lo + min(k, m - 1)];
#pragma unroll
    for (int k = 0; k < kBlock; ++k)
      if (k < m) v[k] = highpass_step(v[k]);
#pragma unroll
    for (int k = 0; k < kBlock; ++k)
      if (hp && k < m) sig[lo + k] = v[k];
  };
  // row 0 toward 0 (warp 6), row 1 toward 1 (warp 7), row 2 (warp 5) toward
  // the target that alternates from the gate's state: closed first if open.
  // Each target is its own instance of the loop.
  const int row = warp >= kEnvWarp ? warp - kEnvWarp : 2;
  const auto fixed_target = [row](int) { return (float)row; };
  const auto alternating_target = [open0](int i) { return (float)((i + open0 + 1) & 1); };
  float envelope = env0;
  auto gate_env_run = [&](int lo, int hi, auto target_of) {
    for (int i = lo; i < hi; ++i) {
      const float target = target_of(i);
      const float coeff = target > envelope ? c.gate_attack : c.gate_release;
      envelope = fused(coeff, sub(target, envelope), envelope);
      env[row * n + i] = envelope;
    }
  };
  const bool hp_lane = warp == kHighpassWarp && lane == 0;
  const bool env_lane = gate && warp >= kEnvWarp && lane == 0;
  const bool alt_lane = alternates && warp == kHighpassWarp + 1 && lane == 0;

  // 4. the NLMS scan, a block of kBlock samples at a time
  for (int b = 0; aec && b < blocks; ++b) {
    const int s = b * kBlock, nb = min(kBlock, n - s);
    {  // (A) p_j = w0 . x_j
      float w0[KW];
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        const int tap = lane + kLanes * k;
        w0[k] = tap < taps ? w_s[tap] : 0.0f;
      }
      for (int j = warp; j < nb; j += kWarps) {
        const float* win = hist + s + j + 1;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < KW; ++k) acc = fused(w0[k], win[lane + kLanes * k], acc);
        acc = warp_sum(acc);
        if (lane == 0) p_s[j] = acc;
      }
    }
    __syncthreads();
    if (warp == 0) {  // (S) the serial step, lane j holding sample s + j
      const float* G = gram[b & 1];
      float m = 0.0f, acc = 0.0f, gm = 0.0f, a = 0.0f;
      if (lane < nb) {
        m = sig[s + lane];
        acc = p_s[lane];
        gm = gmu[s + lane];
        a = mul(gm, inv[s + lane]);
      }
      float e_mine = 0.0f;
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        if (k >= nb) break;
        const float e = sub(m, acc);
        const float ck = __shfl_sync(kAll, mul(a, e), k);
        e_mine = lane == k ? e : e_mine;
        acc = fused(ck, lane < kBlock ? G[k * kBlock + lane] : 0.0f, acc);
      }
      if (lane < nb) {
        g_s[lane] = mul(gm, e_mine);
        sig[s + lane] = e_mine;
      }
    } else if (gram_index(warp) >= 0) {
      if (b + 1 < blocks)
        gram_band<KW>(gram[(b + 1) & 1], hist, s + kBlock, min(kBlock, n - s - kBlock), taps,
                      gram_index(warp), lane);
    } else if (hp_lane) {
      if (b > 0) highpass_block(s - kBlock, kBlock);
    } else if (env_lane) {
      gate_env_run(s, s + nb, fixed_target);
    }
    __syncthreads();
    // (U) each thread's taps take the block's updates in order (audio.py:412)
    // the block's quotients first, all independent, then the sums in order
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int tap = min(t + kThreads * u, kLanes * KW - 1);  // in the padded history
      float step[kBlock];
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        const int at = min(k, nb - 1);
        step[k] = quot_by(mul(g_s[at], hist[s + at + 1 + tap]), norm[s + at], inv[s + at]);
      }
#pragma unroll
      for (int k = 0; k < kBlock; ++k)
        if (k < nb) w[u] = add(w[u], step[k]);
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int tap = t + kThreads * u;
      if (tap < taps) w_s[tap] = w[u];
    }
    __syncthreads();
  }

  // 5. what is left of the highpass and the envelopes (all of them without
  // the AEC, at once), then the gate on the whole frame's peak
  if (hp_lane) {
    if (aec) {
      highpass_block((blocks - 1) * kBlock, n - (blocks - 1) * kBlock);
    } else {  // the whole frame, a sample at a time (faster here than in blocks)
      for (int i = 0; i < n; ++i) {
        const float y = highpass_step(sig[i]);
        if (hp) sig[i] = y;
      }
    }
    peak_s = peak;
    res_s = res_e;
    pin_s = pin;
    pout_s = pout;
  } else if (env_lane) {
    gate_env_run(aec ? n : 0, n, fixed_target);
    env_end[row] = envelope;
  } else if (alt_lane) {
    gate_env_run(0, n, alternating_target);
    env_end[row] = envelope;
  }
  __syncthreads();
  // the gate's targets (audio.py:268-271): 1 above both thresholds; with
  // hysteresis above 1, between them, 1 and 0 in turn; else 0
  const bool above_open = peak_s > c.gate_threshold_open, above = peak_s > c.gate_threshold;
  const int kind = (open0 ? above_open : above && above_open) ? 1 : above && !above_open ? 2 : 0;
  const int open = kind == 2 ? (n + open0) & 1 : kind;
  const float* env_t = env + kind * n;
  for (int i = t; i < n; i += kThreads) out[i] = gate ? mul(sig[i], env_t[i]) : sig[i];

  // 6. the new state and the stats [frozen fraction, sum(e^2), sum(mic^2)]
  if (aec) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int tap = t + kThreads * u;
      if (tap < taps) weights_out[tap] = w[u];
    }
    for (int j = t; j < taps; j += kThreads) far_tail_out[j] = hist[n + j];
  }
  if (t == 0) {
    int frozen = 0;
    float mic_sum = 0.0f;
    for (int q = 0; aec && q < kWarps; ++q) {
      frozen += red_frozen[q];
      mic_sum = add(mic_sum, red_mic[q]);
    }
    out[n] = aec ? mul((float)frozen, c.inv_n) : 0.0f;
    out[n + 1] = aec ? res_s : 0.0f;
    out[n + 2] = aec ? mic_sum : 0.0f;
    if (aec) *hang_out = hang_s;
    if (hp) {
      *hp_in_out = pin_s;
      *hp_out_out = pout_s;
    }
    if (gate) {
      *gate_env_out = env_end[kind];
      *gate_open_out = (uint8_t)open;
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
  const bool aec = stages & kStageAec, gate = stages & kStageGate;
  if (n < 1 || n > kMaxSamples || (stages & ~7) != 0 ||
      (aec && (taps < 1 || taps > kMaxTaps)))
    return cudaErrorInvalidValue;
  if (!aec) taps = 0;
  CaptureConsts c;
  memcpy(&c, consts_host, sizeof(c));
  const int lanes_taps = (taps + kLanes - 1) / kLanes;
  const int kw = lanes_taps <= 1    ? 1
                 : lanes_taps <= 2  ? 2
                 : lanes_taps <= 4  ? 4
                 : lanes_taps <= 8  ? 8
                 : lanes_taps <= 16 ? 16
                                    : 32;
  auto kernel = kw == 1    ? capture_kernel<1>
                : kw == 2  ? capture_kernel<2>
                : kw == 4  ? capture_kernel<4>
                : kw == 8  ? capture_kernel<8>
                : kw == 16 ? capture_kernel<16>
                           : capture_kernel<32>;
  // sig, the envelopes, the padded history, norm, inv, gmu and the weights
  const int envs = gate ? (c.gate_threshold_open > c.gate_threshold ? 3 : 2) : 0;
  const size_t smem = sizeof(float) * ((size_t)n * (1 + envs) +
                                       (aec ? 4 * (size_t)n + kLanes * kw + 2 * kBlock +
                                                  (size_t)taps : 0));
  if (smem > kSmallSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      mic, far, n, taps, stages, hangover, weights, far_tail, hang, hp_in,
      hp_out, gate_env, gate_open, c, out, weights_out, far_tail_out, hang_out,
      hp_in_out, hp_out_out, gate_env_out, gate_open_out);
  return cudaGetLastError();
}
