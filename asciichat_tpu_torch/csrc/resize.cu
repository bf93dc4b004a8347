// K1: bit-exact 16.16 fixed-point nearest-neighbour resize (image.c:267-328).
//
// Replaces asciichat_tpu/ops/pallas_resize.py::resize_nn_pallas (body
// _resize_kernel). The TPU kernel DMAs the 8-row block holding each sampled
// row, picks the row with an int32 one-hot and the columns with a bf16
// one-hot MXU matmul, all to dodge the TPU's scalar-core gather. A Hopper SM
// gathers at no such penalty, so this is the direct gather the TPU kernel
// computes: out[b, y, x] = in[b, sy[y], sx[x]].
//
// Bound: bytes. Each output pixel reads one sampled source pixel (3 bytes,
// one 32-byte sector) and writes 3 bytes; there is no reuse. One thread per
// output pixel, threads along x, so the writes are contiguous and a warp's
// reads fall in one source row. No 8-row padding; 64-bit offsets. The row and
// column tables (sy, sx) come from utils/aspect.resize_indices on the host;
// ops/cells.py also passes half-block row tables here, which makes the two
// half-block RGB modes one launch per record.
//
// At 1080p a column steps 28.4 bytes, under one 32-byte sector, so the
// memory moves every sector of each sampled row: the sector floor (PERF.md,
// section 6), which this kernel reaches most of with L2 cold. A design that
// stages the sampled rows in shared memory with bulk copies
// (tools/k12_staged) was timed in turns with this one and lost, so this one
// stays.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cells_math.cuh"

namespace {

__global__ void __launch_bounds__(256)
    resize_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  const int32_t* __restrict__ sy,
                  const int32_t* __restrict__ sx, int64_t batch, int64_t h,
                  int64_t w, int dh, int dw) {
  const int64_t n = batch * dh * dw;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int x = (int)(i % dw);
    const int64_t row = i / dw;
    const int y = (int)(row % dh);
    const int64_t b = row / dh;
    const uint8_t* p = src + ac::pixel_offset(b, h, w, sy[y], sx[x]);
    uint8_t* q = dst + i * 3;
    q[0] = p[0];
    q[1] = p[1];
    q[2] = p[2];
  }
}

}  // namespace

extern "C" int ac_resize_nn(const uint8_t* src, int64_t batch, int64_t h,
                            int64_t w, const int32_t* sy, int dh,
                            const int32_t* sx, int dw, uint8_t* dst,
                            void* stream) {
  const int64_t n = batch * dh * dw;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop does the rest
  resize_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      src, dst, sy, sx, batch, h, w, dh, dw);
  return cudaGetLastError();
}

// Shared by all three kernels' wrappers: the text of a cudaError_t code.
extern "C" const char* ac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
