// A CPU emulation of the CUDA features that the port's kernels use, for
// running a kernel's source under g++ in the CPU tests: the block's threads
// are std::threads, __shared__ variables are function statics (one copy,
// seen by every thread), __syncthreads is a barrier over the block (and
// __syncthreads_or a vote across it), __syncwarp a barrier over the warp,
// and the warp collectives exchange through per-warp arrays between two
// barriers (__shfl_xor_sync, __shfl_sync and __shfl_up_sync, of any value
// of up to 8 bytes).
// A grid runs its blocks one at a time, in a scrambled order (CUDA promises
// none), on one set of threads that a barrier holds between blocks.
// Dynamic shared memory is one buffer per launch (emu_dynamic_smem: the
// kernel's `extern __shared__` array is rewritten to point at it), and the
// cp.async pipeline (__pipeline_memcpy_async / _commit / _wait_prior) queues
// each thread's copies and performs them only when a wait retires their
// batch, so a read that the kernel does not wait for sees stale data.
// Launch with EMU_LAUNCH(kernel, threads, smem_bytes, args...) in place of
// kernel<<<1, threads, smem_bytes, stream>>>(args), and with
// EMU_LAUNCH_GRID(kernel, blocks, threads, smem_bytes, args...) in place of
// kernel<<<blocks, threads, smem_bytes, stream>>>(args). It runs the kernel's
// logic, not its compiled code: the card's compiler and memory model are
// checked only on the card.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__

struct EmuDim3 {
  int x = 0, y = 0, z = 0;
};
inline thread_local EmuDim3 threadIdx;
inline thread_local EmuDim3 blockIdx;
inline EmuDim3 blockDim, gridDim;

struct alignas(16) uint4 {
  unsigned int x, y, z, w;
};

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline void* emu_dynamic_smem;  // the launch's dynamic shared memory

// cp.async: a thread's copies wait in its open batch, a commit closes the
// batch, and __pipeline_wait_prior(n) performs all but the newest n batches.
struct EmuCopy {
  void* dst;
  const void* src;
  size_t bytes, zfill;
};
inline thread_local std::vector<EmuCopy> emu_open_batch;
inline thread_local std::deque<std::vector<EmuCopy>> emu_batches;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes,
                                    size_t zfill = 0) {
  emu_open_batch.push_back({dst, src, bytes, zfill});
}
inline void __pipeline_commit() {
  emu_batches.push_back(std::move(emu_open_batch));
  emu_open_batch.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  while (emu_batches.size() > n) {
    for (const EmuCopy& c : emu_batches.front()) {
      std::memcpy(c.dst, c.src, c.bytes - c.zfill);
      std::memset(static_cast<char*>(c.dst) + c.bytes - c.zfill, 0, c.zfill);
    }
    emu_batches.pop_front();
  }
}

// A barrier for `count` threads. By default a thread waits by sleeping;
// with EMU_SPIN_BARRIER it waits by yielding its core, which is an order of
// magnitude faster for a kernel that crosses barriers thousands of times a
// launch (a block's threads far outnumber the cores, and each sleep costs a
// wake-up) but keeps every core busy while it runs.
class EmuBarrier {
 public:
  explicit EmuBarrier(int count) : count_(count) {}
  void arrive_and_wait() {
    const unsigned gen = gen_.load(std::memory_order_acquire);
    if (arrived_.fetch_add(1, std::memory_order_acq_rel) + 1 == count_) {
      arrived_.store(0, std::memory_order_relaxed);
      gen_.fetch_add(1, std::memory_order_release);
      gen_.notify_all();
    } else {
      while (gen_.load(std::memory_order_acquire) == gen) {
#ifdef EMU_SPIN_BARRIER
        std::this_thread::yield();
#else
        gen_.wait(gen, std::memory_order_acquire);
#endif
      }
    }
  }

 private:
  const int count_;
  std::atomic<int> arrived_{0};
  std::atomic<unsigned> gen_{0};
};

constexpr int kEmuMaxWarps = 32;
inline EmuBarrier* emu_block;
inline EmuBarrier* emu_warp[kEmuMaxWarps];
inline double emu_xchg[kEmuMaxWarps][32];  // any 8-byte value
inline int emu_bits[kEmuMaxWarps][32];

inline void __syncthreads() { emu_block->arrive_and_wait(); }

// The block's vote: the second barrier holds the reset until every thread
// has read the result.
inline std::atomic<int> emu_vote{0};
inline int __syncthreads_or(int pred) {
  if (pred) emu_vote.store(1);
  emu_block->arrive_and_wait();
  const int any = emu_vote.load();
  emu_block->arrive_and_wait();
  if (threadIdx.x == 0) emu_vote.store(0);
  emu_block->arrive_and_wait();
  return any;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp[threadIdx.x / 32]->arrive_and_wait();
}

// A warp shuffle: every lane posts v, then reads the value of lane
// src(l); a source lane outside the warp reads the lane's own value, as
// __shfl_up_sync does below lane `delta`.
template <class T, class Src>
inline T emu_shuffle(T v, Src src) {
  static_assert(sizeof(T) <= sizeof(emu_xchg[0][0]));
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  std::memcpy(&emu_xchg[w][l], &v, sizeof(T));
  emu_warp[w]->arrive_and_wait();
  const int from = src(l);
  T r = v;
  if (from >= 0 && from < 32) std::memcpy(&r, &emu_xchg[w][from], sizeof(T));
  emu_warp[w]->arrive_and_wait();
  return r;
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_shuffle(v, [&](int l) { return l ^ lane_mask; });
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_shuffle(v, [&](int) { return src_lane; });
}

template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  return emu_shuffle(v, [&](int l) { return l - (int)delta; });
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

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// Run fn on `threads` threads (a multiple of 32, at most 1024) as one block
// with `smem_bytes` of dynamic shared memory, which starts as NaNs so that a
// read of a value never stored shows in the result.
// Run fn as a grid of `blocks` blocks (in a scrambled order) of `threads`
// threads each.
inline void emu_run_grid(int blocks, int threads, size_t smem_bytes,
                         const std::function<void()>& fn) {
  std::vector<int> order(blocks);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), std::mt19937(blocks));
  std::vector<float> smem(smem_bytes / sizeof(float) + 4, NAN);
  emu_dynamic_smem = smem.data();
  gridDim.x = blocks;
  blockDim.x = threads;
  EmuBarrier block(threads);
  emu_block = &block;
  std::vector<std::unique_ptr<EmuBarrier>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.push_back(std::make_unique<EmuBarrier>(32));
    emu_warp[w] = warps.back().get();
  }
  std::vector<std::thread> pool;
  for (int i = 0; i < threads; ++i)
    pool.emplace_back([i, &fn, &order, &block] {
      threadIdx.x = i;
      for (int b : order) {
        blockIdx.x = b;
        fn();
        emu_open_batch.clear();  // copies a thread never waited for
        emu_batches.clear();
        block.arrive_and_wait();  // the next block reuses the shared memory
      }
    });
  for (auto& t : pool) t.join();
}

inline void emu_run(int threads, size_t smem_bytes,
                    const std::function<void()>& fn) {
  emu_run_grid(1, threads, smem_bytes, fn);
}

#define EMU_LAUNCH(kernel, threads, smem_bytes, ...) \
  emu_run(threads, smem_bytes, [&] { kernel(__VA_ARGS__); })
#define EMU_LAUNCH_GRID(kernel, blocks, threads, smem_bytes, ...) \
  emu_run_grid(blocks, threads, smem_bytes, [&] { kernel(__VA_ARGS__); })
