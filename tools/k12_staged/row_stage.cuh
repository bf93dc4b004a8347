// A row-staging design of K1 (resize.cu) and K2 (cell_records.cu) beside
// this file, measured on the card and not shipped. The package's K1 and K2
// (asciichat_tpu_torch/csrc) run a thread per output pixel; timed in turns
// with them (chip_smoke.py --k12-alt tools/k12_staged) this design is slower
// at most timed shapes (PERF.md, section 6). It is kept so that the
// measurement can be repeated (with tools/k12_variants.py) and a later
// design can start from it; the package never loads it. It takes the
// package's C entry points and cells_math.cuh (build with
// -I asciichat_tpu_torch/csrc).
//
// A persistent grid of warps walks the work units (a frame's output row, or a
// tile of its columns), has the bytes of the source rows each unit samples
// copied into a ring of shared-memory slots ahead of use, and runs an
// epilogue over the staged pixels: K1 the identity, K2 its record families
// (records.cuh). Each unit's records are assembled in shared memory and
// stored as 16-byte words.
//
// Bound: bytes. A nearest-neighbour gather from 1080p to 203 columns steps
// 9.46 pixels (28.4 bytes) a column, under one 32-byte sector, so it touches
// every sector of every sampled row: its floor is streaming those rows plus
// the records (PERF.md, section 6). The package's kernels run a thread per
// output pixel, with four 64-bit divisions a pixel and two dependent table
// loads before each pixel's address is known. Here each warp
// decomposes its units once (carried from unit to unit), keeps its
// columns' byte offsets in registers for the whole launch, and requests a
// row with one instruction. On an H100 the copies alone of 128 1080p frames' rows run at
// the rate that a thread a pixel reaches for the whole gather (~2.4 TB/s of
// scattered 5,760-byte rows, where a streaming sum reads ~3.0), so that
// rate, not the kernel, is what holds both designs back (PERF.md, section 6).
//
// A warp is the unit of work, with a ring of its own: its lanes never wait
// on another warp, and what a unit costs besides its columns (finding its
// rows, issuing its copies, its waits) is paid once a warp. One lane issues
// a dense row's copy as one 1-D bulk copy (cp.async.bulk, completed on the
// slot's mbarrier with the row's byte count). The ring has kStages = 2
// slots: one row in flight while one is computed. What covers the memory's
// latency is the SM's warps: a warp's ring is small (11.6 KB at 1080p), so
// ~17 warps share an SM and keep ~17 rows (~98 KB) in flight, against the
// ~18 KB an SM needs at 3.35 TB/s. Rings of 3, 4 and 6 slots, which hold
// fewer warps an SM, measured slower at most timed shapes and no faster
// beyond the calls' spread at any (tools/k12_variants.py, PERF.md).
//
// The staged image of a row mirrors its global addresses from the 16-byte
// granule that holds its tile's first sampled byte, so a pixel sits at its
// row offset plus the row's phase (its address mod 16). Every granule that
// lies inside the frames tensor is copied whole (its bytes outside the span
// are never read); a granule that starts before the tensor or ends past it
// (a view whose first byte, or an end, is not 16-byte aligned) is read
// byte by byte, only the tensor's bytes, so the kernel reads no byte
// outside its input.
//
// Every row stages its whole span, also where the column step is over one
// 32-byte sector (3840 -> 203 columns: 56.7 bytes), where the span holds
// ~1.7x the sectors that the samples touch: copying only the 16-byte
// granules that hold a sample, from a table built on the host, measured
// slower at 4K than the whole span on an H100, and was taken out.
//
// Long rows and few items: a slot holds kMaxSpan bytes (plus 32 of
// alignment); a row whose span exceeds it is cut into column tiles found by
// binary search over the non-decreasing sx. Where every span fits, a row is
// cut into fixed tiles of a multiple of 32 columns (at most kTileCols) when
// the items are fewer than the warps that fit the card, so that small
// batches spread over the card; else a row is one tile.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <mutex>

#include "cells_math.cuh"

namespace ac {

constexpr int kThreads = 32;             // a CTA is one warp, with a ring of its own
constexpr int kStages = 2;               // ring slots a warp: one in flight, one computed
constexpr int kColsPerLane = 8;
constexpr int kTileCols = 32 * kColsPerLane;  // columns a unit
#ifndef AC_MAX_SPAN
#define AC_MAX_SPAN 24576
#endif
constexpr int kMaxSpan = AC_MAX_SPAN;    // staged bytes a unit, a multiple of 16
constexpr int kMaxOutputs = 3;
constexpr int kMaxDevices = 64;

#ifndef EMU_CUDA  // tests/cuda_emu.h supplies these on the CPU
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before the bulk
// copies it issues next (the copies write through the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, int bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbarrier_try_wait_parity(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
#endif

struct Pixel {
  int r, g, b;
};

__device__ __forceinline__ Pixel load_pixel(const uint8_t* p) {
  return Pixel{p[0], p[1], p[2]};
}

__device__ __forceinline__ void store_rgb(uint8_t* dst, int64_t cell,
                                          const Pixel& p) {
  dst[cell * 3 + 0] = (uint8_t)p.r;
  dst[cell * 3 + 1] = (uint8_t)p.g;
  dst[cell * 3 + 2] = (uint8_t)p.b;
}

// The source: a C-contiguous uint8 [batch, h, w, 3] batch, sampled at rows
// sy[.] and columns sx[0..dw) (non-decreasing).
struct RowSource {
  const uint8_t* frames;
  int64_t batch, h, w;
  const int32_t* sy;
  const int32_t* sx;
  int dw;
};

// An epilogue (K1's in resize.cu, K2's in records.cuh) provides:
//   static constexpr int kRows;        source rows an item samples (1 or 2)
//   int rows;                          items a frame
//   int row_of(int r, int k) const;    the sy index of item r's row k
//   static constexpr int bpc(int o);   output o's bytes a cell (0: no output o)
//   uint8_t* out[kMaxOutputs];         the outputs
//   void cell(const Pixel* px, uint8_t* const* stage, int x) const;
// where cell writes column x's records at stage[o] + x * bpc(o).

// The launch's shapes, the same for every warp.
struct StageShape {
  int span;         // staged bytes a unit, at most
  int stage_bytes;  // a ring slot's bytes a row: span + 32 of alignment
  int tile_cols;    // columns a unit at most: fewer where items are few
  int tiles;        // tiles a row, where they are fixed (else 1: see Walk)
  int fixed;        // every row's span fits a stage: tiles are fixed runs of columns
  int rec_bytes;    // the record stage's bytes
  int warp_bytes;   // a warp's ring, record stage, mbarriers and tables
  int64_t workers;  // warps of the launch that take units
};

// What every unit of a launch shares: the span's first and last sampled
// columns, whether a tile is a fixed run of tile_cols columns (every row's
// span fits a stage; else each tile is found by a search, and a warp takes
// whole items) and whether a row is one tile.
struct Walk {
  const RowSource* s;
  int lo, hi, span, tile_cols;
  bool fixed, whole;
  const uint8_t* end;  // one past the frames' last byte
};

// One work unit: item (b, r) and its column tile [x0, x1).
struct Cursor {
  int64_t left;  // the warp's units left (items left where tiles are searched)
  int64_t b;
  int r, x0, x1;
};

// Where a tile of one source row lies: the row's span starts at global
// address a0 + p (p = its phase), and the tile's granules are jlo..jhi,
// counted from a0.
struct Tile {
  uintptr_t a0;
  int p, jlo, jhi;
};

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// The end of the tile that starts at column x0: at most tile_cols columns
// on, and where tiles are searched, the furthest column end whose span
// fits a stage.
__device__ __forceinline__ int tile_end(const Walk& k, int x0) {
  const int b = min(k.s->dw, x0 + k.tile_cols);
  if (k.fixed) return b;
  const int base = __ldg(k.s->sx + x0);
  int a = x0 + 1;  // fits: one pixel
  int c = b;
  while (a < c) {
    const int m = (a + c + 1) / 2;
    if (3 * (__ldg(k.s->sx + m - 1) - base) + 3 <= k.span)
      a = m;
    else
      c = m - 1;
  }
  return a;
}

__device__ __forceinline__ void cursor_next(Cursor& c, const Walk& k, int rows) {
  c.x0 = c.x1;
  if (k.fixed) --c.left;
  if (c.x0 == k.s->dw) {
    c.x0 = 0;
    if (++c.r == rows) {
      c.r = 0;
      ++c.b;
    }
    if (!k.fixed) --c.left;
  }
  if (c.left > 0) c.x1 = tile_end(k, c.x0);
}

// Source row sy of frame b.
__device__ __forceinline__ const uint8_t* row_ptr(const RowSource& s, int64_t b, int sy) {
  return s.frames + pixel_offset(b, s.h, s.w, sy, 0);
}

// Tile c of source row `row`: c0 and c1 bound its sampled bytes, counted
// from the span's start.
__device__ __forceinline__ Tile tile_of(const uint8_t* row, int lo, int c0,
                                        int c1) {
  const uintptr_t start = (uintptr_t)(row + 3 * lo);
  Tile t;
  t.p = (int)(start & 15);
  t.a0 = start - t.p;
  t.jlo = (t.p + c0) >> 4;
  t.jhi = (t.p + c1 - 1) >> 4;
  return t;
}

// The byte range [c0, c1) of unit c's tile, counted from the span's start.
__device__ __forceinline__ void tile_bytes(const Walk& k, const Cursor& c, int* c0, int* c1) {
  *c0 = k.whole ? 0 : 3 * (__ldg(k.s->sx + c.x0) - k.lo);
  *c1 = 3 * ((k.whole ? k.hi : __ldg(k.s->sx + c.x1 - 1)) - k.lo) + 3;
}

// The bytes of granule g (16-byte aligned) that lie in [begin, end), read
// by the warp's lanes into dst: a granule the tensor does not hold whole.
__device__ __forceinline__ void copy_partial(uint8_t* dst, const uint8_t* g,
                                             const uint8_t* begin, const uint8_t* end,
                                             int lane) {
  const uint8_t* a = g + lane;
  if (lane < 16 && a >= begin && a < end) dst[lane] = *a;
}

// What a unit's copies need from memory, loaded before they are issued (a
// unit ahead, or all at once for the first units): its source rows, its
// tile's sampled bytes [c0, c1) from the span's start, and where a row is
// cut into tiles, this lane's columns as byte offsets from the span's start.
template <int kRows>
struct Ahead {
  int sy[kRows];
  int c0, c1;
  int rel[kColsPerLane];
};

template <class Epi>
__device__ __forceinline__ void fetch(Ahead<Epi::kRows>& a, const Walk& k, const Epi& epi,
                                      const Cursor& c, int lane) {
#pragma unroll
  for (int row = 0; row < Epi::kRows; ++row) a.sy[row] = __ldg(k.s->sy + epi.row_of(c.r, row));
  tile_bytes(k, c, &a.c0, &a.c1);
  if (!k.whole) {
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int x = c.x0 + lane + 32 * i;
      a.rel[i] = x < c.x1 ? 3 * (__ldg(k.s->sx + x) - k.lo) : -1;
    }
  }
}

// The warp's copies of unit c's rows into ring slot `slot`. A row's whole
// granules go as one bulk copy, issued by lane 0, completing on `bar` (lane
// 0 arrives on it with the bytes the copies bring); a granule the tensor
// does not hold whole is read by the lanes, and every unit commits a
// cp.async group (the variants of tools/k12_variants.py copy through it). Lane 0 puts where each row's first
// sampled byte sits, less its tile's first granule, in `at`, and where a row
// is cut into tiles the lanes put their columns in `rel`, for the lanes that
// compute the unit.
template <int kRows>
__device__ __forceinline__ void produce(const Walk& k, const Cursor& c, const Ahead<kRows>& a,
                                        uint8_t* slot, uint64_t* bar, int* at, int* rel,
                                        int stage_bytes, int lane) {
  const RowSource& s = *k.s;
  const int c0 = a.c0, c1 = a.c1;
  if (!k.whole) {
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) rel[lane + 32 * i] = a.rel[i];
  }
  int bytes = 0;
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    const Tile tl = tile_of(row_ptr(s, c.b, a.sy[row]), k.lo, c0, c1);
    if (lane == 0) at[row] = tl.p - 16 * tl.jlo;
    uint8_t* dst = slot + row * stage_bytes - 16 * tl.jlo;  // granule j at dst + 16 j
    const uint8_t* a0 = (const uint8_t*)tl.a0;
    const int first = tl.jlo, last = tl.jhi;  // the tile's granules
    const bool head_part = a0 + 16 * first < s.frames;
    const bool tail_part = a0 + 16 * (last + 1) > k.end;
    if (head_part) copy_partial(dst + 16 * first, a0 + 16 * first, s.frames, k.end, lane);
    if (tail_part && (last != first || !head_part))
      copy_partial(dst + 16 * last, a0 + 16 * last, s.frames, k.end, lane);
    const int g0 = first + head_part, g1 = last - tail_part;
    if (g1 >= g0) {
      bytes += 16 * (g1 - g0 + 1);
      if (lane == 0) {
        fence_proxy_async();
        bulk_copy_to_shared(dst + 16 * g0, a0 + 16 * g0, 16 * (g1 - g0 + 1), bar);
      }
    }
  }
  __pipeline_commit();
  if (lane == 0) mbarrier_arrive_expect_tx(bar, bytes);
}

// Every warp takes a contiguous range of units and walks them with two
// cursors: one kStages units ahead that has copies issued into the ring,
// one that computes. A unit's lanes wait for their cp.async group and, after
// a warp barrier that makes those copies (and the record stage's last
// reads) the warp's, on its slot's mbarrier; the epilogue writes the
// tile's records into the record stage, aligned as their rows will be, and
// after a second warp barrier, which also frees the unit's slot for the
// copies kStages units on, the lanes store them as 16-byte words.
template <class Epi>
__global__ void __launch_bounds__(kThreads)
    row_stage_kernel(const RowSource s, const __grid_constant__ Epi epi,
                     const StageShape shape) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int64_t worker = blockIdx.x;
  Walk k;
  k.s = &s;
  k.lo = __ldg(s.sx);
  k.hi = __ldg(s.sx + s.dw - 1);
  k.span = shape.span;
  k.tile_cols = shape.tile_cols;
  k.fixed = shape.fixed != 0;
  k.whole = k.fixed && s.dw <= shape.tile_cols;
  k.end = s.frames + s.batch * s.h * s.w * 3;

  // the warp's ring, its record stage (one buffer an output, 16-byte
  // aligned, with 16 bytes of slack for its row's phase) and the ring's
  // barriers and tables
  uint8_t* ring = smem;
  uint8_t* recs = ring + kStages * Epi::kRows * shape.stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(recs + shape.rec_bytes);
  int* slot_at = reinterpret_cast<int*>(bars + kStages);  // [kStages][kRows]: produce's `at`
  int* slot_rel = slot_at + kStages * Epi::kRows;  // [kStages][kTileCols]: its `rel`, tiles only
  int rec_at[kMaxOutputs];  // each output's offset in the record stage
  {
    const int cols = min(s.dw, kTileCols);
    int at = 0;
#pragma unroll
    for (int o = 0; o < kMaxOutputs; ++o) {
      rec_at[o] = at;
      if (Epi::bpc(o)) at += round16(cols * Epi::bpc(o)) + 16;
    }
  }
  if (lane == 0) {
    for (int i = 0; i < kStages; ++i) mbarrier_init(bars + i, 1);
    fence_mbarrier_init();
  }
  __syncwarp();

  // the warp's units [u0, u1), decomposed once (in 32 bits where they fit)
  const int64_t n = s.batch * epi.rows * shape.tiles;
  Cursor cur;
  int tile;
  if (n * shape.workers < INT32_MAX) {
    const unsigned m = (unsigned)n, g = (unsigned)shape.workers, w = (unsigned)worker;
    const unsigned u0 = m * w / g, item = u0 / (unsigned)shape.tiles;
    cur.left = m * (w + 1) / g - u0;
    tile = (int)(u0 - item * (unsigned)shape.tiles);
    cur.b = item / (unsigned)epi.rows;
    cur.r = (int)(item % (unsigned)epi.rows);
  } else {
    const int64_t u0 = n * worker / shape.workers, item = u0 / shape.tiles;
    cur.left = n * (worker + 1) / shape.workers - u0;
    tile = (int)(u0 - item * shape.tiles);
    cur.b = item / epi.rows;
    cur.r = (int)(item - cur.b * epi.rows);
  }
  cur.x0 = tile * shape.tile_cols;
  cur.x1 = tile_end(k, cur.x0);
  Cursor ahead = cur;
  const int slot_bytes = Epi::kRows * shape.stage_bytes;

  // the first kStages units: what they need loaded all at once, then their
  // copies
  Ahead<Epi::kRows> next, first[kStages];
  {
    Cursor c = cur;
#pragma unroll
    for (int u = 0; u < kStages; ++u) {
      if (c.left > 0) {
        fetch(first[u], k, epi, c, lane);
        cursor_next(c, k, epi.rows);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kStages; ++u) {
    if (ahead.left > 0) {
      produce<Epi::kRows>(k, ahead, first[u], ring + u * slot_bytes, bars + u,
                          slot_at + u * Epi::kRows, slot_rel + u * kTileCols,
                          shape.stage_bytes, lane);
      cursor_next(ahead, k, epi.rows);
    } else {
      __pipeline_commit();
    }
  }
  if (ahead.left > 0) fetch(next, k, epi, ahead, lane);

  // this lane's columns, as byte offsets from lo, where a row is one tile:
  // loaded once, while the first copies are in flight (else each unit's
  // come with its copies, in slot_rel)
  int rel[kColsPerLane];
  if (k.whole) {
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int x = lane + 32 * i;
      rel[i] = x < s.dw ? 3 * (__ldg(s.sx + x) - k.lo) : -1;
    }
  }
  int slot = 0, parity = 0;
  while (cur.left > 0) {
    const int64_t orow = cur.b * epi.rows + cur.r;
    const int cols = cur.x1 - cur.x0;
    uint8_t* dst[kMaxOutputs];
    uint8_t* out[kMaxOutputs];
#pragma unroll
    for (int o = 0; o < kMaxOutputs; ++o) {
      dst[o] = Epi::bpc(o) ? epi.out[o] + (orow * s.dw + cur.x0) * Epi::bpc(o) : nullptr;
      out[o] = recs + rec_at[o] + ((uintptr_t)dst[o] & 15);
    }
    __pipeline_wait_prior(kStages - 1);
    __syncwarp();
    while (!mbarrier_try_wait_parity(bars + slot, parity)) {
    }
    const uint8_t* stage[Epi::kRows];
#pragma unroll
    for (int row = 0; row < Epi::kRows; ++row)
      stage[row] = ring + slot * slot_bytes + row * shape.stage_bytes +
                   slot_at[slot * Epi::kRows + row];
    if (!k.whole) {
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) rel[i] = slot_rel[slot * kTileCols + lane + 32 * i];
    }
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      if (32 * i >= cols) break;
      if (rel[i] < 0) continue;
      Pixel px[Epi::kRows];
#pragma unroll
      for (int row = 0; row < Epi::kRows; ++row) px[row] = load_pixel(stage[row] + rel[i]);
      epi.cell(px, out, lane + 32 * i);
    }
    __syncwarp();
    if (ahead.left > 0) {
      produce<Epi::kRows>(k, ahead, next, ring + slot * slot_bytes, bars + slot,
                          slot_at + slot * Epi::kRows, slot_rel + slot * kTileCols,
                          shape.stage_bytes, lane);
      cursor_next(ahead, k, epi.rows);
      if (ahead.left > 0) fetch(next, k, epi, ahead, lane);
    } else {
      __pipeline_commit();
    }

    // the tile's records: ragged bytes at each end, 16-byte words between
#pragma unroll
    for (int o = 0; o < kMaxOutputs; ++o) {
      if (!Epi::bpc(o)) continue;
      const int len = cols * Epi::bpc(o);
      const int head = min(len, (16 - (int)((uintptr_t)dst[o] & 15)) & 15);
      const int words = (len - head) >> 4;
      const int tail = len - head - 16 * words;
      const uint4* from = reinterpret_cast<const uint4*>(out[o] + head);
      uint4* to = reinterpret_cast<uint4*>(dst[o] + head);
      for (int e = lane; e < words; e += 32) to[e] = from[e];
      if (lane < head) dst[o][lane] = out[o][lane];
      if (lane >= 16 && lane < 16 + tail) {
        const int e = head + 16 * words + lane - 16;
        dst[o][e] = out[o][e];
      }
    }
    cursor_next(cur, k, epi.rows);
    if (++slot == kStages) {
      slot = 0;
      parity ^= 1;
    }
  }
}

__host__ __forceinline__ int64_t round16_host(int64_t v) { return (v + 15) & ~int64_t{15}; }

// The CTAs that fit the card at once (occupancy x SMs). The opt-in to
// dynamic shared memory past 48 KB and the occupancy are asked once per
// kernel, device and size, so that a launch captured into a CUDA graph
// makes no such call. The opt-in only ever rises (to the largest size asked
// on the device), so a size remembered from before stays allowed.
template <class Epi>
cudaError_t row_stage_capacity(size_t smem, int64_t* capacity) {
  constexpr int kWays = 4;  // sizes remembered a device
  static std::atomic<uint64_t> cache[kMaxDevices][kWays];  // (smem << 16) | capacity
  static std::mutex opt_in_mutex;
  static size_t opted_in[kMaxDevices];  // the opt-in set on each device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::atomic<uint64_t>* ways = cache[dev % kMaxDevices];
  for (int i = 0; i < kWays; ++i) {
    const uint64_t seen = ways[i].load();
    if (seen && seen >> 16 == smem) {
      *capacity = (int64_t)(seen & 0xffff);
      return cudaSuccess;
    }
  }
  if (smem > 48 * 1024) {
    std::lock_guard<std::mutex> lock(opt_in_mutex);
    if (smem > opted_in[dev % kMaxDevices]) {
      rc = cudaFuncSetAttribute(row_stage_kernel<Epi>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc != cudaSuccess) return rc;
      opted_in[dev % kMaxDevices] = smem;
    }
  }
  int per_sm = 0, sms = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_stage_kernel<Epi>,
                                                     kThreads, smem);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidValue;  // the stages do not fit an SM
  const int64_t cap = std::min<int64_t>((int64_t)per_sm * sms, 0xffff);
  ways[smem / 16 % kWays].store((uint64_t)smem << 16 | (uint64_t)cap);
  *capacity = cap;
  return cudaSuccess;
}

// The launch: as many warps as fit the card at once, never more than the
// units. Where the items are fewer than the warps, a row is cut into tiles
// of a multiple of 32 columns, so that the warps share the work.
template <class Epi>
cudaError_t launch_row_stage(const RowSource& s, const Epi& epi, cudaStream_t stream) {
  const int64_t n = s.batch * epi.rows;
  if (n == 0 || s.dw == 0) return cudaSuccess;
  StageShape shape;
  shape.span = (int)std::min<int64_t>(round16_host(3 * s.w), kMaxSpan);
  shape.stage_bytes = shape.span + 32;
  const int cols = std::min(s.dw, kTileCols);
  shape.rec_bytes = 0;
  for (int o = 0; o < kMaxOutputs; ++o)
    if (Epi::bpc(o)) shape.rec_bytes += (int)round16_host((int64_t)cols * Epi::bpc(o)) + 16;
  // a warp's ring, record stages, barriers and `at` table; a row cut into
  // tiles adds its columns' slots (slot_rel)
  const int base_bytes = kStages * Epi::kRows * shape.stage_bytes + shape.rec_bytes +
                         (8 + 4 * Epi::kRows) * kStages;
  shape.warp_bytes = (int)round16_host(base_bytes);
  int64_t capacity = 0;
  cudaError_t rc = row_stage_capacity<Epi>(shape.warp_bytes, &capacity);
  if (rc != cudaSuccess) return rc;
  shape.fixed = 3 * s.w <= kMaxSpan;  // then every span fits: hi - lo < w
  shape.tile_cols = kTileCols;
  shape.tiles = 1;
  if (shape.fixed) {
    const int64_t groups = (s.dw + 31) / 32;  // 32-column groups a row
    const int64_t want = std::max<int64_t>(1, std::min<int64_t>(groups, capacity / n));
    shape.tile_cols = (int)std::min<int64_t>(kTileCols, 32 * ((groups + want - 1) / want));
    shape.tiles = (s.dw + shape.tile_cols - 1) / shape.tile_cols;
  }
  if (!shape.fixed || shape.tiles > 1) {
    shape.warp_bytes = (int)round16_host(base_bytes + 4 * kStages * kTileCols);
    rc = row_stage_capacity<Epi>(shape.warp_bytes, &capacity);
    if (rc != cudaSuccess) return rc;
  }
  const size_t smem = shape.warp_bytes;
  shape.workers = std::min(capacity, n * shape.tiles);
  const int64_t grid = shape.workers;
  row_stage_kernel<Epi><<<(unsigned)grid, kThreads, smem, stream>>>(s, epi, shape);
  return cudaGetLastError();
}

}  // namespace ac
