// A CPU emulation of the CUDA features that a single-block kernel uses, for
// running a kernel's source under g++ in the CPU tests: the block's threads
// are std::threads, __shared__ variables are function statics (one copy,
// seen by every thread), __syncthreads is a barrier over the block, and the
// warp collectives exchange through per-warp arrays between two barriers.
// Launch with EMU_LAUNCH(kernel, args...) in place of kernel<<<1, n>>>(args).
// It runs the kernel's logic, not its compiled code: the card's compiler
// and memory model are checked only on the card.
#pragma once

#include <barrier>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static

struct EmuDim3 {
  int x = 0, y = 0, z = 0;
};
inline thread_local EmuDim3 threadIdx;

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

constexpr int kEmuMaxWarps = 32;
inline std::barrier<>* emu_block;
inline std::barrier<>* emu_warp[kEmuMaxWarps];
inline float emu_xchg[kEmuMaxWarps][32];
inline int emu_bits[kEmuMaxWarps][32];

inline void __syncthreads() { emu_block->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_xchg[w][l] = v;
  emu_warp[w]->arrive_and_wait();
  const float r = emu_xchg[w][l ^ lane_mask];
  emu_warp[w]->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_bits[w][l] = pred != 0;
  emu_warp[w]->arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) bits |= (unsigned)emu_bits[w][i] << i;
  emu_warp[w]->arrive_and_wait();
  return bits;
}

inline int __popc(unsigned v) { return __builtin_popcount(v); }

// Run fn on `threads` threads (a multiple of 32, at most 1024) as one block.
inline void emu_run(int threads, const std::function<void()>& fn) {
  std::barrier<> block(threads);
  emu_block = &block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.push_back(std::make_unique<std::barrier<>>(32));
    emu_warp[w] = warps.back().get();
  }
  std::vector<std::thread> pool;
  for (int i = 0; i < threads; ++i)
    pool.emplace_back([i, &fn] {
      threadIdx.x = i;
      fn();
    });
  for (auto& t : pool) t.join();
}

#define EMU_LAUNCH(kernel, threads, ...) \
  emu_run(threads, [&] { kernel(__VA_ARGS__); })
