// K2's (cell_records.cu) per-mode cell-record body. It is templated on the
// record family and on the source addressing (K2 reads a frame batch
// through resize tables); everything after the pixel load is this one body.
// K3 (render_group.cu) has a body of its own, with the same per-element
// math from cells_math.cuh.
//
// One thread per output cell, cells in row-major order, so neighbouring
// threads write neighbouring record bytes. A grid-stride loop covers any
// batch; all offsets are 64-bit. The same body as the epilogue of a
// row-staging kernel is tools/k12_staged/records.cuh, measured and not
// shipped (PERF.md, section 6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cells_math.cuh"

namespace ac {

// The palette's luma->key ramp rides by value in the kernel's parameters,
// which live in the constant bank: no module state, nothing to upload, and
// two palettes on two streams cannot race.
struct Ramp {
  uint8_t v[64];
};

struct Records {
  uint8_t* o0;
  uint8_t* o1;
  uint8_t* o2;
};

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

// Src::load(b, y, x) returns the (filtered) pixel at pixel row y, column x of
// frame b of the resized batch.
template <int FAM, class Src>
__global__ void __launch_bounds__(256)
    records_kernel(const Src src, const __grid_constant__ Ramp ramp,
                   const Records out, int64_t batch, int rows, int width,
                   int hpx) {
  const int64_t n = batch * rows * width;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int x = (int)(i % width);
    const int64_t br = i / width;
    const int r = (int)(br % rows);
    const int64_t b = br / rows;
    if constexpr (is_halfblock(FAM)) {
      const Pixel top = src.load(b, 2 * r, x);
      const Pixel bot = src.load(b, hb_bot_row(r, hpx), x);
      if constexpr (FAM == FAM_HB_RGB) {
        store_rgb(out.o0, i, top);
        store_rgb(out.o1, i, bot);
      } else {
        if constexpr (FAM == FAM_HB_Q16) {
          out.o0[i] = (uint8_t)q16(top.r, top.g, top.b);
          out.o1[i] = (uint8_t)q16(bot.r, bot.g, bot.b);
        } else {
          out.o0[i] = (uint8_t)q256(top.r, top.g, top.b);
          out.o1[i] = (uint8_t)q256(bot.r, bot.g, bot.b);
        }
        out.o2[i] =
            (uint8_t)((top.r | top.g | top.b | bot.r | bot.g | bot.b) == 0);
      }
    } else {
      const Pixel p = src.load(b, r, x);
      const int y = luma(p.r, p.g, p.b);
      if constexpr (FAM == FAM_MONO) {
        out.o0[i] = (uint8_t)mono_key(ramp.v, y);
      } else if constexpr (FAM == FAM_RGB_LUMA) {
        store_rgb(out.o0, i, p);
        out.o1[i] = (uint8_t)y;
      } else if constexpr (FAM == FAM_Q256_LUMA) {
        out.o0[i] = (uint8_t)q256(p.r, p.g, p.b);
        out.o1[i] = (uint8_t)y;
      } else {  // FAM_Q16_KEY
        out.o0[i] = (uint8_t)q16(p.r, p.g, p.b);
        out.o1[i] = (uint8_t)mono_key(ramp.v, y);
      }
    }
  }
}

template <int FAM, class Src>
cudaError_t launch_records(const Src& src, const uint8_t* ramp_host,
                           const Records& out, int64_t batch, int hpx,
                           int width, cudaStream_t stream) {
  const int rows = is_halfblock(FAM) ? (hpx + 1) / 2 : hpx;
  const int64_t n = batch * rows * width;
  if (n == 0) return cudaSuccess;
  Ramp ramp;
  for (int k = 0; k < 64; ++k) ramp.v[k] = ramp_host[k];
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop does the rest
  records_kernel<FAM, Src><<<(unsigned)blocks, threads, 0, stream>>>(
      src, ramp, out, batch, rows, width, hpx);
  return cudaGetLastError();
}

}  // namespace ac
