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
// batch, so a read that the kernel does not wait for sees stale data. Built
// with EMU_COPY_EARLY, a copy lands as soon as it is issued instead (the
// other end of what the card allows), so a copy into shared memory that
// other threads may still be reading shows in their result.
// The occupancy query answers EMU_BLOCKS_PER_SM (2) and the card has
// EMU_SMS (3) SMs, so that a persistent grid has a few CTAs.
// Hopper's mbarrier and 1-D bulk copy (EMU_CUDA tells a kernel's source to
// take these in place of its PTX): mbarrier_init, mbarrier_arrive_expect_tx,
// bulk_copy_to_shared (16-byte aligned ends and a multiple of 16 bytes, as
// the card requires, else the run aborts) and mbarrier_try_wait_parity. A
// bulk copy lands only when a wait on its barrier retires it (with
// EMU_COPY_EARLY, at once), and a barrier's phase completes when its
// arrivals are in and its transaction count is back at zero.
// cudaMemcpy2DAsync is a loop of host copies over its lines, done when called.
// Launch with EMU_LAUNCH(kernel, threads, smem_bytes, args...) in place of
// kernel<<<1, threads, smem_bytes, stream>>>(args), and with
// EMU_LAUNCH_GRID(kernel, blocks, threads, smem_bytes, args...) in place of
// kernel<<<blocks, threads, smem_bytes, stream>>>(args) (or
// EMU_LAUNCH_GRID_LIMITED, which also holds the launch to its kernel's
// opt-in to dynamic shared memory past 48 KB). It runs the kernel's
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
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <numeric>
#include <unordered_map>
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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidPitchValue = 12 };
inline thread_local cudaError_t emu_last_error = cudaSuccess;  // a launch that failed
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
// A 2-D copy (cudaMemcpy2DAsync): `height` lines of `width` bytes, each
// source line `spitch` bytes after the last and each destination line
// `dpitch`, done at once on the host. A pitch under the width is refused,
// as the card refuses it.
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1 };
inline cudaError_t cudaMemcpy2DAsync(void* dst, size_t dpitch, const void* src, size_t spitch,
                                     size_t width, size_t height, cudaMemcpyKind, cudaStream_t) {
  if (width > dpitch || width > spitch) return cudaErrorInvalidPitchValue;
  for (size_t y = 0; y < height; ++y)
    std::memcpy(static_cast<char*>(dst) + y * dpitch, static_cast<const char*>(src) + y * spitch,
                width);
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
// Each kernel's opt-in to dynamic shared memory past 48 KB, as the last
// cudaFuncSetAttribute set it. EMU_LAUNCH_GRID_LIMITED holds a launch to
// it, as the card does: past 48 KB and past the opt-in, the launch fails
// and cudaGetLastError says so.
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline std::mutex emu_opt_in_mutex;
inline std::unordered_map<const void*, int> emu_opt_in;
template <typename F>
cudaError_t cudaFuncSetAttribute(F kernel, cudaFuncAttribute, int bytes) {
  std::lock_guard<std::mutex> lock(emu_opt_in_mutex);
  emu_opt_in[reinterpret_cast<const void*>(kernel)] = bytes;
  return cudaSuccess;
}
inline bool emu_smem_allowed(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  std::lock_guard<std::mutex> lock(emu_opt_in_mutex);
  const auto it = emu_opt_in.find(kernel);
  return it != emu_opt_in.end() && bytes <= (size_t)it->second;
}

#ifndef EMU_BLOCKS_PER_SM
#define EMU_BLOCKS_PER_SM 2
#endif
#ifndef EMU_SMS
#define EMU_SMS 3
#endif
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = EMU_BLOCKS_PER_SM;
  return cudaSuccess;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = EMU_SMS;
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

inline void emu_perform(const EmuCopy& c) {
  std::memcpy(c.dst, c.src, c.bytes - c.zfill);
  std::memset(static_cast<char*>(c.dst) + c.bytes - c.zfill, 0, c.zfill);
}

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes,
                                    size_t zfill = 0) {
#ifdef EMU_COPY_EARLY
  emu_perform({dst, src, bytes, zfill});
#else
  emu_open_batch.push_back({dst, src, bytes, zfill});
#endif
}
inline void __pipeline_commit() {
  emu_batches.push_back(std::move(emu_open_batch));
  emu_open_batch.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  while (emu_batches.size() > n) {
    for (const EmuCopy& c : emu_batches.front()) emu_perform(c);
    emu_batches.pop_front();
  }
}

#define EMU_CUDA 1

struct EmuMbarrier {
  int count = 0, pending = 0;
  long tx = 0;
  unsigned phase = 0;
  std::vector<EmuCopy> queued;
};
inline std::mutex emu_mbar_mutex;
inline std::unordered_map<const void*, EmuMbarrier> emu_mbars;  // one launch's block

inline EmuMbarrier& emu_mbar(const void* bar) {
  auto it = emu_mbars.find(bar);
  if (it == emu_mbars.end()) {
    std::fprintf(stderr, "cuda_emu: mbarrier %p used before mbarrier_init\n", bar);
    std::abort();
  }
  return it->second;
}

inline void emu_mbar_settle(EmuMbarrier& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.count;
  }
}

inline void mbarrier_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  EmuMbarrier& m = emu_mbars[bar];
  m = EmuMbarrier{};
  m.count = m.pending = count;
}
inline void fence_mbarrier_init() {}
inline void fence_proxy_async() {}

inline void mbarrier_arrive_expect_tx(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  EmuMbarrier& m = emu_mbar(bar);
  m.tx += bytes;
  m.pending -= 1;
  emu_mbar_settle(m);
}

inline void bulk_copy_to_shared(void* dst, const void* src, int bytes, uint64_t* bar) {
  if (((uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes) % 16 != 0 || bytes <= 0) {
    std::fprintf(stderr, "cuda_emu: bulk copy of %d bytes %p -> %p is not 16-byte aligned\n",
                 bytes, src, dst);
    std::abort();
  }
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  EmuMbarrier& m = emu_mbar(bar);
#ifdef EMU_COPY_EARLY
  std::memcpy(dst, src, bytes);
  m.tx -= bytes;
  emu_mbar_settle(m);
#else
  m.queued.push_back({dst, src, (size_t)bytes, 0});
#endif
}

// True once the phase of parity `parity` has completed; a wait on a phase
// that has not lands the barrier's copies first.
inline bool mbarrier_try_wait_parity(uint64_t* bar, int parity) {
  thread_local long spins = 0;
  {
    std::lock_guard<std::mutex> lock(emu_mbar_mutex);
    EmuMbarrier& m = emu_mbar(bar);
    for (const EmuCopy& c : m.queued) {
      std::memcpy(c.dst, c.src, c.bytes);
      m.tx -= (long)c.bytes;
    }
    m.queued.clear();
    emu_mbar_settle(m);
    if ((int)(m.phase & 1) != parity) {
      spins = 0;
      return true;
    }
  }
  if (++spins > 20000000L) {
    std::fprintf(stderr, "cuda_emu: a wait on mbarrier %p never completes\n", (void*)bar);
    std::abort();
  }
  std::this_thread::yield();
  return false;
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
        if (i == 0) emu_mbars.clear();
        block.arrive_and_wait();
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
#define EMU_LAUNCH_GRID_LIMITED(kernel, blocks, threads, smem_bytes, ...)                 \
  (emu_smem_allowed(reinterpret_cast<const void*>(&kernel), smem_bytes)                 \
       ? emu_run_grid(blocks, threads, smem_bytes, [&] { kernel(__VA_ARGS__); })        \
       : (void)(emu_last_error = cudaErrorInvalidValue))
