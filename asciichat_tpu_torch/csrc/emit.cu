// K6: truecolor-FG ANSI bytes on the device, in tiles of 1,024 cells.
//
// Replaces the XLA graph asciichat_tpu/ops/emit.py::emit_truecolor_fg (body
// _emit_one, emit.py:74-149): cell records (rgb, luma) -> the byte-exact
// frame of render/oracle.render_truecolor_fg, at most 20 bytes a cell plus
// one ESC[0m, and its length. The JAX function compacts the variable-length
// cell chunks with a searchsorted gather over every output byte because a
// TPU runs dynamic addressing on its scalar core; on Hopper the compaction
// is a scan of the cells' byte lengths, and the bytes are assembled in
// shared memory and stored to the frame's row as whole 16-byte words.
//
// A cell opens with ESC[38;2;R;G;Bm when its colour differs from its raster
// predecessor's (the state crosses row ends and tile edges; the first cell
// of a frame always opens), then its glyph, then '\n' at the end of every
// row but the last. A tile is kTile consecutive cells in raster order; both
// launches run one CTA per (tile, frame), a 1-D grid of frames x tiles with
// the tile fastest (so no frame count hits the grid's y limit):
//
// 1. tile sums (CTAs of 128 threads, so that 1,536 fit the card at once):
//    the CTA stages the tile's colours (and its predecessor's) into shared
//    memory with 16-byte loads, each thread sums the SGRs of 8 consecutive
//    cells, a block reduction adds the glyphs and the row ends (counted,
//    not tested cell by cell) and writes tile_sum[frame, tile];
// 2. emit: the CTA sums tile_sum[frame, :tile] (its offset in the row) and
//    tile_sum[frame, :] (the frame's length) by block reductions, stages
//    its colours and luma, builds a decimal table (the digits of 0..255
//    and ';', one word each), and each warp takes 32 consecutive cells a
//    step: a shuffle scan of their lengths, carried across the warp's steps
//    and, through one block scan of the warps' totals, across warps, places
//    each cell's <= 21 bytes in a shared-memory staging buffer that holds
//    the whole tile's bytes, aligned as the row will be. The CTA then
//    stores the tile's contiguous range of the row coalesced: the ragged
//    head and tail byte by byte, the body as 16-byte words of consecutive
//    threads at consecutive addresses. The frame's last tile writes the
//    reset and the length, and every tile of the frame zeroes its share of
//    [length, stride) with 16-byte stores.
//
// Bound: bytes. The function reads 4 record bytes a cell and writes the
// whole worst-case buffer (20 bytes a cell + 4); the design reads the
// colours twice (once a launch) and 8 bytes a tile of sums. Its integer
// work is a few dozen operations a cell, but every output byte is still a
// byte store into shared memory, and each CTA waits on its staging loads
// before it computes: on the card the emit launch is bound by instruction
// issue and that latency, not by its stores (PERF.md, section 6). No block
// waits on another: the only dependence between CTAs is the launch
// boundary.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;               // cells a CTA (ops/emit.py TILE)
constexpr int kThreads = 256;             // the emit launch's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = kTile / kThreads;  // 32-cell steps of each warp
constexpr int kSumThreads = 128;          // the tile-sum launch's CTA: one wave of 1,536 fits
constexpr int kSumCells = kTile / kSumThreads;  // consecutive cells a thread there
constexpr int kCellMax = 21;              // ESC[38;2;RRR;GGG;BBBm + glyph + '\n'
constexpr int kColourBytes = 3 * (kTile + 1) + 16;  // + the predecessor, + alignment
constexpr unsigned kFull = 0xffffffffu;

struct Glyphs {  // one ASCII glyph per clamped luminance, by value
  uint8_t g[256];
};

__device__ __forceinline__ int digits(int v) { return 1 + (v >= 10) + (v >= 100); }

// Entry v of the decimal table: the digits of v (0..255) without leading
// zeros, most significant first from the low byte up, then ';'.
__device__ __forceinline__ uint32_t decimal(int v) {
  const uint32_t h = '0' + v / 100, t = '0' + (v / 10) % 10, o = '0' + v % 10;
  if (v >= 100) return h | t << 8 | o << 16 | (uint32_t)';' << 24;
  if (v >= 10) return t | o << 8 | (uint32_t)';' << 16;
  return o | (uint32_t)';' << 8;
}

__device__ __forceinline__ int sgr_length(int c) {
  return 10 + digits(c >> 16) + digits((c >> 8) & 255) + digits(c & 255);
}

// The colour of staged cell k (p + 3k) packed as 0xRRGGBB.
__device__ __forceinline__ int colour_at(const uint8_t* p, int k) {
  p += 3 * k;
  return (p[0] << 16) | (p[1] << 8) | p[2];
}

// The colour that cell i (staged as k) is held against: its raster
// predecessor's, staged just before it even across a row end or a tile
// edge; -1 for the frame's first cell, which always opens.
__device__ __forceinline__ int predecessor(const uint8_t* p, int k, int i) {
  return i > 0 ? colour_at(p, k - 1) : -1;
}

// Bytes [from, to) of src to dst, both 16-byte aligned bases, by a CTA of
// T threads: the ragged head and tail byte by byte, the whole 16-byte
// words between them as uint4 loads and stores of consecutive threads at
// consecutive addresses.
template <int T>
__device__ void copy_span(uint8_t* dst, const uint8_t* src, int from, int to) {
  const int first = (from + 15) >> 4, last = to >> 4;  // whole words [first, last)
  for (int j = from + threadIdx.x; j < min(to, first * 16); j += T) dst[j] = src[j];
  for (int q = first + threadIdx.x; q < last; q += T)
    reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(src)[q];
  for (int j = max(first, last) * 16 + threadIdx.x; j < to; j += T) dst[j] = src[j];
}

// Stage count bytes at src into buf (16-byte aligned) at buf + (src & 15),
// so that the 16-byte words of both line up; returns the staged first byte.
template <int T>
__device__ const uint8_t* stage(uint8_t* buf, const uint8_t* src, int count) {
  const int shift = (int)((uintptr_t)src & 15);
  copy_span<T>(buf, src - shift, shift, shift + count);
  return buf + shift;
}

// Stage the colours of cells [c0 - 1, c1) of a frame (from c0 for the
// first tile); returns p with p + 3k the colour of cell c0 + k.
template <int T>
__device__ const uint8_t* stage_colours(uint8_t* buf, const uint8_t* frame_rgb, int c0, int c1) {
  const int from = c0 > 0 ? c0 - 1 : 0;
  return stage<T>(buf, frame_rgb + 3 * (int64_t)from, 3 * (c1 - from)) + 3 * (c0 - from);
}

// The sum of v over a CTA of T threads, to every thread; scratch holds
// T / 32 ints.
template <int T>
__device__ void block_sum(int& v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int k = 0; k < T / 32; ++k) v += scratch[k];
  __syncthreads();  // scratch is free again
}

// Row ends (the cells i with (i + 1) % w == 0, but the frame's last) in [c0, c1).
__device__ __forceinline__ int row_ends(int c0, int c1, int n, int w) {
  return c1 / w - c0 / w - (c1 == n);
}

// A cell's len bytes at p. A cell that opens: ESC[38;2; then R's and G's
// table entries, 4 bytes each whatever their digits, the bytes past each
// field's ';' overwritten by the next field's stores (one thread's stores
// to one address land in program order, and no field's four bytes reach
// past the cell); then, exactly, B's digits, 'm', the glyph and the
// newline. Any other cell: the glyph and the newline.
__device__ __forceinline__ void put_cell(uint8_t* p, int c, int len, bool nl, uint32_t glyph,
                                         const uint32_t* dec) {
  uint64_t tail = glyph | (nl ? (uint32_t)'\n' << 8 : 0u);
  int tail_len = 1 + nl;
  if (len > tail_len) {
    p[0] = 0x1b; p[1] = '['; p[2] = '3'; p[3] = '8'; p[4] = ';'; p[5] = '2'; p[6] = ';';
    const int r = c >> 16, g = (c >> 8) & 255, b = c & 255;
    const uint32_t er = dec[r], eg = dec[g];
    uint8_t* q = p + 7;
    q[0] = (uint8_t)er; q[1] = (uint8_t)(er >> 8); q[2] = (uint8_t)(er >> 16);
    q[3] = (uint8_t)(er >> 24);
    q += digits(r) + 1;
    q[0] = (uint8_t)eg; q[1] = (uint8_t)(eg >> 8); q[2] = (uint8_t)(eg >> 16);
    q[3] = (uint8_t)(eg >> 24);
    q += digits(g) + 1;
    const int db = digits(b);
    const uint64_t eb = dec[b] ^ (uint32_t)(';' ^ 'm') << (8 * db);  // 'm' for B's ';'
    tail = eb | tail << (8 * (db + 1));
    tail_len += db + 1;
    p = q;
  }
  const uint32_t lo = (uint32_t)tail, hi = (uint32_t)(tail >> 32);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < tail_len) p[j] = (uint8_t)(lo >> (8 * j));
#pragma unroll
  for (int j = 4; j < 6; ++j)
    if (j < tail_len) p[j] = (uint8_t)(hi >> (8 * (j - 4)));
}

// Zero bytes [from, to) of row with the frame's CTAs sharing the work
// (thread g of G): bytes up to the first 16-byte boundary, 16-byte stores
// between the boundaries, bytes after the last one.
__device__ void zero_span(uint8_t* row, int64_t from, int64_t to, int64_t g, int64_t G) {
  const uintptr_t a = (uintptr_t)(row + from), e = (uintptr_t)(row + to);
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, e16 = e & ~(uintptr_t)15;
  const uintptr_t head_end = a16 < e ? a16 : e;
  for (uintptr_t p = a + g; p < head_end; p += G) *(uint8_t*)p = 0;
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (uintptr_t q = a16 + 16 * (uintptr_t)g; q < e16; q += 16 * (uintptr_t)G) *(uint4*)q = zero;
  for (uintptr_t p = (e16 > head_end ? e16 : head_end) + g; p < e; p += G) *(uint8_t*)p = 0;
}

__global__ void __launch_bounds__(kSumThreads)
    tile_sums_kernel(const uint8_t* __restrict__ rgb, int h, int w, int tiles,
                     int32_t* __restrict__ tile_sum) {
  __shared__ __align__(16) uint8_t col[kColourBytes];
  __shared__ int scratch[kSumThreads / 32];
  const int tile = blockIdx.x % tiles;
  const int64_t frame = blockIdx.x / tiles;
  const int n = h * w;
  const int c0 = tile * kTile, c1 = min(n, c0 + kTile), cells = c1 - c0;
  const uint8_t* px = stage_colours<kSumThreads>(col, rgb + frame * n * 3, c0, c1);
  __syncthreads();
  // a thread's kSumCells consecutive cells: their SGRs; the glyphs and the
  // row ends are counted for the whole tile
  const int k0 = threadIdx.x * kSumCells;
  int sum = 0;
  if (k0 < cells) {
    int prev = predecessor(px, k0, c0 + k0);
#pragma unroll
    for (int j = 0; j < kSumCells; ++j) {
      if (k0 + j < cells) {
        const int c = colour_at(px, k0 + j);
        sum += c != prev ? sgr_length(c) : 0;
        prev = c;
      }
    }
  }
  block_sum<kSumThreads>(sum, scratch);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = sum + cells + row_ends(c0, c1, n, w);
}

__global__ void __launch_bounds__(kThreads)
    emit_tiles_kernel(const uint8_t* __restrict__ rgb, const uint8_t* __restrict__ luma,
                      const __grid_constant__ Glyphs glyphs, int h, int w, int tiles,
                      const int32_t* __restrict__ tile_sum, uint8_t* __restrict__ out,
                      int64_t stride, int32_t* __restrict__ lengths) {
  __shared__ __align__(16) uint8_t col[kColourBytes];
  __shared__ __align__(16) uint8_t lum[kTile + 16];
  __shared__ __align__(16) uint8_t staged[kCellMax * kTile + 16];
  __shared__ uint32_t dec[256];
  __shared__ uint8_t glyph[256];
  __shared__ int scratch[kWarps];
  const int tile = blockIdx.x % tiles;
  const int64_t frame = blockIdx.x / tiles;
  const int n = h * w;
  const int c0 = tile * kTile, c1 = min(n, c0 + kTile), cells = c1 - c0;
  uint8_t* row = out + frame * stride;

  // 1. the tile's colours and luma, the glyph and decimal tables in shared
  // memory; the tile's offset in the row and the frame's length
  const uint8_t* px = stage_colours<kThreads>(col, rgb + frame * n * 3, c0, c1);
  const uint8_t* lu = stage<kThreads>(lum, luma + frame * n + c0, cells);
  glyph[threadIdx.x] = glyphs.g[threadIdx.x];  // kThreads == 256
  dec[threadIdx.x] = decimal(threadIdx.x);
  int before = 0, total = 0;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int s = tile_sum[frame * tiles + t];
    total += s;
    before += t < tile ? s : 0;
  }
  block_sum<kThreads>(before, scratch);  // its barriers also end the staging
  block_sum<kThreads>(total, scratch);

  // 2. warp w takes cells [w * 32 * kSteps, (w + 1) * 32 * kSteps) of the
  // tile, 32 consecutive cells a step; colours and lengths stay in registers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = warp * 32 * kSteps + lane;
  int len[kSteps], c[kSteps];
  bool nl[kSteps];
  int col_i = (c0 + first) % w, mine = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k = first + 32 * s, i = c0 + k;
    nl[s] = col_i == w - 1 && i != n - 1;
    len[s] = c[s] = 0;
    if (k < cells) {
      c[s] = colour_at(px, k);
      len[s] = (c[s] != predecessor(px, k, i) ? sgr_length(c[s]) : 0) + 1 + nl[s];
    }
    mine += len[s];
    col_i = w > 32 ? (col_i + 32 >= w ? col_i + 32 - w : col_i + 32) : (col_i + 32) % w;
  }
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(kFull, mine, o);
  if (lane == 0) scratch[warp] = mine;
  __syncthreads();
  int base = 0, tile_len = 0;
  for (int v = 0; v < kWarps; ++v) {
    base += v < warp ? scratch[v] : 0;
    tile_len += scratch[v];
  }

  // the staging buffer lines up with the row: staged[shift + j] is byte
  // before + j of the row
  uint8_t* dst = row + before;
  const int shift = (int)((uintptr_t)dst & 15);
  int pos = shift + base;  // this warp's next step
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    int incl = len[s];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (len[s])
      put_cell(staged + pos + incl - len[s], c[s], len[s], nl[s],
               glyph[lu[first + 32 * s]], dec);
    pos += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  copy_span<kThreads>(dst - shift, staged, shift, shift + tile_len);

  // 3. the frame's end: the reset and the length from its last tile, the
  // zeros past it from all of its tiles
  if (tile == tiles - 1 && threadIdx.x == 0) {
    uint8_t* p = row + total;
    p[0] = 0x1b; p[1] = '['; p[2] = '0'; p[3] = 'm';
    lengths[frame] = total + 4;
  }
  zero_span(row, total + 4, stride, (int64_t)tile * kThreads + threadIdx.x,
            (int64_t)tiles * kThreads);
}

}  // namespace

// rgb u8 [batch, h, w, 3] and luma u8 [batch, h, w] on the card, glyph_host
// 256 bytes on the host (copied into the launch), out u8 [batch, stride]
// with stride >= h * w * 20 + 4, lengths i32 [batch], and tile_sum, the
// i32 scratch of at least batch * ceil(h * w / 1024) values that the first
// launch writes and the second reads. Two launches on the stream.
extern "C" int ac_device_emit(const uint8_t* rgb, const uint8_t* luma, const uint8_t* glyph_host,
                              int batch, int h, int w, uint8_t* out, int64_t stride,
                              int32_t* lengths, int32_t* tile_sum, int64_t tile_sum_count,
                              void* stream) {
  if (batch == 0) return cudaSuccess;
  const int64_t n = (int64_t)h * w;
  if (h <= 0 || w <= 0 || n > 0x7fffffff / 20 || stride < n * 20 + 4) return cudaErrorInvalidValue;
  const int tiles = (int)((n + kTile - 1) / kTile);
  const int64_t grid = (int64_t)batch * tiles;
  if (tile_sum_count < grid || grid > 0x7fffffff) return cudaErrorInvalidValue;
  Glyphs glyphs;
  for (int k = 0; k < 256; ++k) glyphs.g[k] = glyph_host[k];
  const int blocks = (int)grid;
  const cudaStream_t s = (cudaStream_t)stream;
  tile_sums_kernel<<<blocks, kSumThreads, 0, s>>>(rgb, h, w, tiles, tile_sum);
  const int rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  emit_tiles_kernel<<<blocks, kThreads, 0, s>>>(rgb, luma, glyphs, h, w, tiles, tile_sum, out,
                                                stride, lengths);
  return cudaGetLastError();
}
