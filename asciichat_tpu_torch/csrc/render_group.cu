// K3: the server tick's render of every geometry group in one launch:
// composite gather, per-receiver colour filter, resize and cell records.
//
// Replaces the XLA graph asciichat_tpu/models/server.py::render_compute
// (server.py:58-91 with ops/filters.py:110-128): gather frames[cidx, sy, sx]
// with a black background, broadcast to C receivers, filter each, resize,
// then records_for_mode. Composite and resize are both pure selections, so
// the host composes them once per layout and stack shape
// (ops/compositor.pixel_words) into one int32 word per output pixel: the
// byte offset of the source pixel in the stack, or -1 for the black
// background. The filter is per pixel, so filtering after the gather equals
// the reference's filter-then-resize; the background is filtered too, as in
// the reference.
//
// Bound: bytes, and few of them: a 9-receiver 203x64 half-block tick
// samples ~26k pixels through a 104 KB map and writes ~700 KB of records,
// ~0.26 us at 3.35 TB/s. What holds it back is latency: the launch, the map
// word, then the pixel it points at (two dependent trips to memory), then
// each receiver's records. The design keeps that chain short and does the
// rest once:
//  - One CTA per tile: one cell row of one group, or a chunk of it (the
//    host sizes the chunks so that a group alone has about one tile per SM;
//    models/server.tile_width). The tiles of the tick's groups are
//    concatenated: a CTA finds its group in the descriptor table, never
//    straddles two, and dispatches on the group's record family.
//  - The descriptor table (map, geometry, record pointers, each receiver's
//    filter and the palette ramp) rides by value in a __grid_constant__
//    parameter, in the constant bank: no per-receiver tensor reaches the
//    card, and a rainbow tint changes on the host with no upload.
//  - The tile's map words (pixel row r, or for half-block rows 2r and its
//    bottom row) are staged in shared memory by cp.async, each thread
//    copying the words it then gathers. Each sampled pixel is then loaded
//    once for all of the group's receivers, with its filter gray, into
//    shared memory: the tile's one barrier.
//  - Threads then walk the (receiver, cell) pairs, cells fastest, colourise
//    from shared memory and store each record byte from registers, so that
//    neighbouring threads write neighbouring bytes.
// Records staged in shared memory for 16-byte stores measured slower on the
// card at the server's shapes (tools/k3_variants.py, PERF.md): they add a
// second barrier and a pass over shared memory to a chain that latency, not
// bandwidth, bounds, where each CTA writes a few KB.
// The per-element math is cells_math.cuh's, as in K2.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "cells_math.cuh"

namespace {

// The host side (models/server.py K3_*) keeps the same numbers.
constexpr int kMaxGroups = 16;      // descriptors per launch
constexpr int kMaxReceivers = 16;   // receivers per descriptor
constexpr int kMaxTileCells = 256;  // cells per tile
constexpr int kDescWords = 25;      // int64 words per descriptor in the host table
constexpr int kThreads = 256;

// One receiver's filter (ops/filters.py filter_params), by value.
struct Receiver {
  uint8_t r, g, b, flags;
};
constexpr int kEnabled = 1, kFgOnBg = 2, kRainbow = 4;

// One descriptor: a group, or up to kMaxReceivers of its receivers.
struct Group {
  const int32_t* words;  // [hpx, width] byte offsets in the stack, -1 background
  uint8_t* out[3];       // the family's records at the first receiver
  int tile0;             // the group's first tile (CTA) in the launch
  int hpx, width, tile_w, family, receivers;
  Receiver recv[kMaxReceivers];
  uint8_t ramp[64];  // the palette's luma -> key ramp
};

struct Launch {
  const uint8_t* frames;  // the tick's source stack, uint8 [S, H, W, 3]
  int groups;
  Group g[kMaxGroups];
};
static_assert(sizeof(Launch) <= 4096, "the parameters must fit in 4 KB");

// The family's records (ops/cells.py FAMILY_RECORDS) and each one's bytes
// per cell.
__host__ __device__ constexpr int record_count(int fam) {
  return fam == ac::FAM_MONO ? 1
         : (fam == ac::FAM_HB_Q256 || fam == ac::FAM_HB_Q16) ? 3
                                                              : 2;
}
__host__ __device__ constexpr int record_bytes(int fam, int o) {
  return fam == ac::FAM_HB_RGB || (fam == ac::FAM_RGB_LUMA && o == 0) ? 3 : 1;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// One gathered pixel: r | g << 8 | b << 16 | filter_gray << 24.
__device__ __forceinline__ uint32_t gather(const uint8_t* __restrict__ frames,
                                           int32_t word) {
  if (word < 0) return 0;  // background: black, whose gray is 0
  const uint8_t* s = frames + word;
  const int r = __ldg(s), g = __ldg(s + 1), b = __ldg(s + 2);
  return (uint32_t)r | (uint32_t)g << 8 | (uint32_t)b << 16 |
         (uint32_t)ac::filter_gray(r, g, b) << 24;
}

struct Pixel {
  int r, g, b;
};

// Receiver f's view of a gathered pixel.
__device__ __forceinline__ Pixel filtered(uint32_t v, const Receiver& f) {
  Pixel p{(int)(v & 255u), (int)(v >> 8 & 255u), (int)(v >> 16 & 255u)};
  ac::colorize(p.r, p.g, p.b, (int)(v >> 24), f.r, f.g, f.b,
               (f.flags & kFgOnBg) != 0, (f.flags & kRainbow) != 0,
               (f.flags & kEnabled) != 0);
  return p;
}

template <int FAM>
__device__ __forceinline__ void render_tile(const uint8_t* __restrict__ frames,
                                            const Group& d, int tile,
                                            uint32_t* pix) {
  constexpr bool kHalf = ac::is_halfblock(FAM);
  constexpr int kPlanes = kHalf ? 2 : 1;  // pixel rows per cell row
  constexpr int kRecs = record_count(FAM);
  const int rows = kHalf ? (d.hpx + 1) / 2 : d.hpx;
  const int chunks = (d.width + d.tile_w - 1) / d.tile_w;
  const int r = tile / chunks;
  const int x0 = tile % chunks * d.tile_w;
  const int n = imin(d.tile_w, d.width - x0);
  const int t = threadIdx.x;

  // 1. The tile's map words, staged in `pix` by cp.async. Each thread
  //    copies the words of the pixels it gathers, so it waits for its own
  //    copies only, with no barrier.
  for (int q = t; q < kPlanes * n; q += kThreads) {
    const int pl = q >= n, x = q - pl * n;
    const int y = pl == 0 ? (kHalf ? 2 * r : r) : ac::hb_bot_row(r, d.hpx);
    __pipeline_memcpy_async(pix + pl * kMaxTileCells + x,
                            d.words + (int64_t)y * d.width + x0 + x, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  // 2. Each sampled pixel of the tile once, for every receiver, in place of
  //    its word.
  for (int q = t; q < kPlanes * n; q += kThreads) {
    const int i = q < n ? q : kMaxTileCells + q - n;
    pix[i] = gather(frames, (int32_t)pix[i]);
  }
  __syncthreads();

  // 3. The records of each (receiver, cell) pair. Records are [C, rows,
  //    width, k]: receiver c's bytes of record o for this tile start at
  //    out[o] + c * step[o].
  uint8_t* out[kRecs];
  int64_t step[kRecs];
  for (int o = 0; o < kRecs; ++o) {
    const int k = record_bytes(FAM, o);
    out[o] = d.out[o] + ((int64_t)r * d.width + x0) * k;
    step[o] = (int64_t)rows * d.width * k;
  }
  const int dc = kThreads / n, dx = kThreads - dc * n;  // n <= kThreads
  int c = t / n, x = t - c * n;
  for (; c < d.receivers; c += dc, x += dx) {
    if (x >= n) {
      x -= n;
      if (++c >= d.receivers) break;
    }
    const Receiver f = d.recv[c];
    uint8_t* s[kRecs];
    for (int o = 0; o < kRecs; ++o) s[o] = out[o] + c * step[o] + x * record_bytes(FAM, o);
    const Pixel top = filtered(pix[x], f);
    if constexpr (kHalf) {
      const Pixel bot = filtered(pix[kMaxTileCells + x], f);
      if constexpr (FAM == ac::FAM_HB_RGB) {
        s[0][0] = (uint8_t)top.r;
        s[0][1] = (uint8_t)top.g;
        s[0][2] = (uint8_t)top.b;
        s[1][0] = (uint8_t)bot.r;
        s[1][1] = (uint8_t)bot.g;
        s[1][2] = (uint8_t)bot.b;
      } else {
        if constexpr (FAM == ac::FAM_HB_Q16) {
          s[0][0] = (uint8_t)ac::q16(top.r, top.g, top.b);
          s[1][0] = (uint8_t)ac::q16(bot.r, bot.g, bot.b);
        } else {
          s[0][0] = (uint8_t)ac::q256(top.r, top.g, top.b);
          s[1][0] = (uint8_t)ac::q256(bot.r, bot.g, bot.b);
        }
        s[2][0] =
            (uint8_t)((top.r | top.g | top.b | bot.r | bot.g | bot.b) == 0);
      }
    } else {
      const int y = ac::luma(top.r, top.g, top.b);
      if constexpr (FAM == ac::FAM_MONO) {
        s[0][0] = (uint8_t)ac::mono_key(d.ramp, y);
      } else if constexpr (FAM == ac::FAM_RGB_LUMA) {
        s[0][0] = (uint8_t)top.r;
        s[0][1] = (uint8_t)top.g;
        s[0][2] = (uint8_t)top.b;
        s[1][0] = (uint8_t)y;
      } else if constexpr (FAM == ac::FAM_Q256_LUMA) {
        s[0][0] = (uint8_t)ac::q256(top.r, top.g, top.b);
        s[1][0] = (uint8_t)y;
      } else {  // FAM_Q16_KEY
        s[0][0] = (uint8_t)ac::q16(top.r, top.g, top.b);
        s[1][0] = (uint8_t)ac::mono_key(d.ramp, y);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    render_groups_kernel(const __grid_constant__ Launch p) {
  __shared__ uint32_t pix[2 * kMaxTileCells];
  int gi = 0;
  while (gi + 1 < p.groups && (int)blockIdx.x >= p.g[gi + 1].tile0) ++gi;
  const Group& d = p.g[gi];
  const int tile = (int)blockIdx.x - d.tile0;
  switch (d.family) {
    case ac::FAM_MONO:
      render_tile<ac::FAM_MONO>(p.frames, d, tile, pix);
      break;
    case ac::FAM_RGB_LUMA:
      render_tile<ac::FAM_RGB_LUMA>(p.frames, d, tile, pix);
      break;
    case ac::FAM_Q256_LUMA:
      render_tile<ac::FAM_Q256_LUMA>(p.frames, d, tile, pix);
      break;
    case ac::FAM_Q16_KEY:
      render_tile<ac::FAM_Q16_KEY>(p.frames, d, tile, pix);
      break;
    case ac::FAM_HB_RGB:
      render_tile<ac::FAM_HB_RGB>(p.frames, d, tile, pix);
      break;
    case ac::FAM_HB_Q256:
      render_tile<ac::FAM_HB_Q256>(p.frames, d, tile, pix);
      break;
    default:  // FAM_HB_Q16 (the host checked the family)
      render_tile<ac::FAM_HB_Q16>(p.frames, d, tile, pix);
      break;
  }
}

}  // namespace

// frames: the tick's source stack on the card. table: int64 [groups,
// kDescWords] on the host, one row per descriptor (models/server.k3_tables):
// [0] the word map, [1-3] records o0-o2 at the descriptor's first receiver
// (0 past the family's count), [4] hpx, [5] width, [6] tile_w (cells per
// tile), [7] family, [8] receivers, [9-16] the receivers' filters ({r, g,
// b, flags} x kMaxReceivers), [17-24] the palette ramp (64 bytes). One
// launch over every descriptor's tiles.
extern "C" int ac_render_groups(const uint8_t* frames, const int64_t* table,
                                int groups, void* stream) {
  if (groups < 1 || groups > kMaxGroups) return cudaErrorInvalidValue;
  Launch p;
  memset(&p, 0, sizeof p);
  p.frames = frames;
  p.groups = groups;
  int64_t tiles = 0;
  for (int i = 0; i < groups; ++i) {
    const int64_t* row = table + (int64_t)i * kDescWords;
    Group& d = p.g[i];
    d.words = reinterpret_cast<const int32_t*>((uintptr_t)row[0]);
    for (int o = 0; o < 3; ++o)
      d.out[o] = reinterpret_cast<uint8_t*>((uintptr_t)row[1 + o]);
    d.hpx = (int)row[4];
    d.width = (int)row[5];
    d.tile_w = (int)row[6];
    d.family = (int)row[7];
    d.receivers = (int)row[8];
    memcpy(d.recv, row + 9, sizeof d.recv);
    memcpy(d.ramp, row + 17, sizeof d.ramp);
    const bool ok = d.family >= ac::FAM_MONO && d.family <= ac::FAM_HB_Q16 &&
                    d.hpx > 0 && d.width > 0 && d.receivers > 0 &&
                    d.receivers <= kMaxReceivers && d.tile_w > 0 &&
                    d.tile_w <= kMaxTileCells;
    if (!ok) return cudaErrorInvalidValue;
    d.tile0 = (int)tiles;
    const int rows = ac::is_halfblock(d.family) ? (d.hpx + 1) / 2 : d.hpx;
    tiles += (int64_t)rows * ((d.width + d.tile_w - 1) / d.tile_w);
    if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  }
  render_groups_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}
