// K6: truecolor-FG ANSI bytes on the device, one frame per CTA.
//
// Replaces the XLA graph asciichat_tpu/ops/emit.py::emit_truecolor_fg (body
// _emit_one, emit.py:74-149): cell records (rgb, luma) -> the byte-exact
// frame of render/oracle.render_truecolor_fg, at most 20 bytes a cell plus
// one ESC[0m, and its length. The JAX function compacts the variable-length
// cell chunks with a searchsorted gather over every output byte because a
// TPU runs dynamic addressing on its scalar core; on Hopper a block scan of
// the cells' lengths and a scatter of each chunk to its offset is the
// natural compaction, so that is what this kernel does:
//
// 1. each thread takes a contiguous run of cells and sums their lengths: a
//    cell opens with ESC[38;2;R;G;Bm when its colour differs from its raster
//    predecessor's (the state crosses row ends; the first cell always
//    opens), then its glyph, then '\n' at the end of every row but the last;
// 2. a block-wide exclusive scan of the runs' sums (warp shuffles, then one
//    warp over the warp totals in shared memory) gives each run its offset;
// 3. each thread writes its cells' bytes straight at their offsets (digits
//    without leading zeros), the last thread writes the reset and the
//    length, and every thread zeroes its share of [length, stride) with
//    16-byte stores, so the buffer past the frame is 0 as in the JAX
//    function.
//
// Bound: bytes. It reads 4 record bytes a cell and writes the whole
// worst-case buffer (20 bytes a cell + 4); its integer work is a few dozen
// operations a cell. The cell bytes are byte stores at data-dependent
// offsets: simple first (no staging of a run's bytes into wide stores).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Glyphs {  // one ASCII glyph per clamped luminance, by value
  uint8_t g[256];
};

__device__ __forceinline__ int digits(int v) { return 1 + (v >= 10) + (v >= 100); }

// v in 0..255 as decimal digits, most significant first; returns the count.
__device__ __forceinline__ int put_decimal(uint8_t* p, int v) {
  if (v >= 100) {
    p[0] = (uint8_t)('0' + v / 100);
    p[1] = (uint8_t)('0' + (v / 10) % 10);
    p[2] = (uint8_t)('0' + v % 10);
    return 3;
  }
  if (v >= 10) {
    p[0] = (uint8_t)('0' + v / 10);
    p[1] = (uint8_t)('0' + v % 10);
    return 2;
  }
  p[0] = (uint8_t)('0' + v);
  return 1;
}

// The colour of cell i packed as 0xRRGGBB.
__device__ __forceinline__ int colour(const uint8_t* px, int i) {
  const uint8_t* p = px + 3 * (int64_t)i;
  return (p[0] << 16) | (p[1] << 8) | p[2];
}

__device__ __forceinline__ int sgr_length(int c) {
  return 10 + digits(c >> 16) + digits((c >> 8) & 255) + digits(c & 255);
}

// Zero [from, to) of row: bytes up to the first 16-byte boundary, 16-byte
// stores between the boundaries, bytes after the last one.
__device__ void zero_range(uint8_t* row, int64_t from, int64_t to) {
  const uintptr_t a = (uintptr_t)(row + from), e = (uintptr_t)(row + to);
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, e16 = e & ~(uintptr_t)15;
  const uintptr_t head_end = a16 < e ? a16 : e;
  for (uintptr_t p = a + threadIdx.x; p < head_end; p += kThreads) *(uint8_t*)p = 0;
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (uintptr_t q = a16 + 16 * (uintptr_t)threadIdx.x; q < e16; q += 16 * (uintptr_t)kThreads)
    *(uint4*)q = zero;
  for (uintptr_t p = (e16 > head_end ? e16 : head_end) + threadIdx.x; p < e; p += kThreads)
    *(uint8_t*)p = 0;
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(const uint8_t* __restrict__ rgb, const uint8_t* __restrict__ luma,
                const __grid_constant__ Glyphs glyphs, int h, int w,
                uint8_t* __restrict__ out, int64_t stride, int32_t* __restrict__ lengths) {
  __shared__ int warp_total[kWarps];
  const int64_t frame = blockIdx.x;
  const int n = h * w;
  const uint8_t* px = rgb + frame * n * 3;
  const uint8_t* lu = luma + frame * n;
  uint8_t* row = out + frame * stride;
  const int per = (n + kThreads - 1) / kThreads;
  const int begin = min(n, (int)threadIdx.x * per);
  const int end = min(n, begin + per);

  // 1. this thread's bytes
  int sum = 0;
  int prev = begin > 0 ? colour(px, begin - 1) : -1;  // -1: the first cell opens
  for (int i = begin; i < end; ++i) {
    const int c = colour(px, i);
    sum += (c != prev ? sgr_length(c) : 0) + 1 + ((i + 1) % w == 0 && i != n - 1);
    prev = c;
  }

  // 2. block-wide exclusive scan of the sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_total[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_total[lane] = t;
  }
  __syncthreads();
  const int total = warp_total[kWarps - 1];
  int pos = (warp > 0 ? warp_total[warp - 1] : 0) + incl - sum;

  // 3. the cells' bytes at their offsets
  prev = begin > 0 ? colour(px, begin - 1) : -1;
  for (int i = begin; i < end; ++i) {
    const int c = colour(px, i);
    uint8_t* p = row + pos;
    int k = 0;
    if (c != prev) {
      p[0] = 0x1b; p[1] = '['; p[2] = '3'; p[3] = '8'; p[4] = ';'; p[5] = '2'; p[6] = ';';
      k = 7;
      k += put_decimal(p + k, c >> 16);
      p[k++] = ';';
      k += put_decimal(p + k, (c >> 8) & 255);
      p[k++] = ';';
      k += put_decimal(p + k, c & 255);
      p[k++] = 'm';
    }
    p[k++] = glyphs.g[lu[i]];
    if ((i + 1) % w == 0 && i != n - 1) p[k++] = '\n';
    pos += k;
    prev = c;
  }
  const int length = total + 4;
  if (threadIdx.x == kThreads - 1) {
    uint8_t* p = row + total;
    p[0] = 0x1b; p[1] = '['; p[2] = '0'; p[3] = 'm';
    lengths[frame] = length;
  }
  zero_range(row, length, stride);
}

}  // namespace

// rgb u8 [batch, h, w, 3] and luma u8 [batch, h, w] on the card, glyph_host
// 256 bytes on the host (copied into the launch), out u8 [batch, stride]
// with stride >= h * w * 20 + 4, lengths i32 [batch].
extern "C" int ac_device_emit(const uint8_t* rgb, const uint8_t* luma, const uint8_t* glyph_host,
                              int batch, int h, int w, uint8_t* out, int64_t stride,
                              int32_t* lengths, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (h <= 0 || w <= 0 || stride < (int64_t)h * w * 20 + 4) return cudaErrorInvalidValue;
  Glyphs glyphs;
  for (int k = 0; k < 256; ++k) glyphs.g[k] = glyph_host[k];
  emit_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(rgb, luma, glyphs, h, w, out,
                                                            stride, lengths);
  return cudaGetLastError();
}
