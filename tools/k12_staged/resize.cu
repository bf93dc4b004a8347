// K1 as a row-staging kernel (row_stage.cuh): the design measured against
// the package's K1 (asciichat_tpu_torch/csrc/resize.cu) and not shipped. It
// takes the package's C entry point, ac_resize_nn.
//
// The same function: asciichat_tpu/ops/pallas_resize.py::resize_nn_pallas
// (body _resize_kernel). The TPU kernel DMAs the 8-row block holding each sampled
// row, picks the row with an int32 one-hot and the columns with a bf16
// one-hot MXU matmul, all to dodge the TPU's scalar-core gather, whose 57
// single-row fetches a frame are DMA-descriptor-bound. On Hopper the same
// row fetch is what the memory system does best: this is the row-staging
// kernel of row_stage.cuh with the identity epilogue, out[b, y, x] =
// in[b, sy[y], sx[x]], each sampled row streamed into shared memory a few
// rows ahead of the gather from it.
//
// Bound: bytes, at the sector floor. Each output pixel reads one sampled
// source pixel and writes 3 bytes, with no reuse; at 1080p a column steps
// 28.4 bytes, under one 32-byte sector, so the memory moves every sector of
// each sampled row: 42.0 MB of rows and 4.44 MB of pixels at B=128 -> 57x203
// (46.5 MB, 13.87 us at 3.35 TB/s). The row and column tables (sy, sx) come
// from utils/aspect.resize_indices on the host; ops/cells.py also passes
// half-block row tables here, which makes the two half-block RGB modes one
// launch per record.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"

namespace {

// The identity epilogue: an item is an output row y, which samples row y.
struct CopyEpilogue {
  static constexpr int kRows = 1;
  __host__ __device__ static constexpr int bpc(int o) { return o == 0 ? 3 : 0; }
  int rows;
  uint8_t* out[ac::kMaxOutputs];

  __device__ __forceinline__ int row_of(int r, int) const { return r; }

  __device__ __forceinline__ void cell(const ac::Pixel* px, uint8_t* const* o,
                                       int i) const {
    ac::store_rgb(o[0], i, px[0]);
  }
};

}  // namespace

extern "C" int ac_resize_nn(const uint8_t* src, int64_t batch, int64_t h,
                            int64_t w, const int32_t* sy, int dh,
                            const int32_t* sx, int dw, uint8_t* dst,
                            void* stream) {
  CopyEpilogue epi{dh, {dst, nullptr, nullptr}};
  return ac::launch_row_stage(ac::RowSource{src, batch, h, w, sy, sx, dw},
                              epi, (cudaStream_t)stream);
}

// Shared by all the kernels' wrappers: the text of a cudaError_t code.
extern "C" const char* ac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
