// Ingest of the sampled source rows: pinned host frames -> a compact device
// batch [B, count, W, 3] that holds only the rows K1 and K2 read.
//
// Replaces no TPU kernel: the JAX package uploads whole frames
// (asciichat_tpu/render/pipeline.py:75, jnp.asarray). K1 and K2 are
// nearest-neighbour gathers, and at 1080p a sampled column steps 28.4 bytes,
// under one 32-byte sector, so they read every byte of each sampled row and
// nothing of any other row (resize.cu). At 1080p -> 57 pixel rows that is
// 5.3% of the frame: 42.0 MB a call of 128 frames, against 796 MB whole.
//
// Bound: the host link. The copy engine moves the bytes; no SM is involved.
// A sampled row lies at the same offset in every frame of the batch, one
// frame stride apart, so one 2-D copy takes it from all B frames: B lines of
// W * 3 bytes, the source pitch the frame stride, the destination pitch one
// compact frame (count rows). The sampled rows are not evenly spaced (steps
// of 18 and 19 rows at 57 of 1080), so no single 2-D or 3-D copy takes them
// all: one cudaMemcpy2DAsync a row, all issued by this one call on the
// caller's stream. Nothing here waits: the caller's stream orders the copies
// before the kernels that read them, and the caller keeps the host frames
// untouched until the stream has passed them.
#include <cuda_runtime.h>
#include <stdint.h>

// rows: `count` host int32 source row indices; row rows[i] of every frame
// lands in row i of the compact batch at dst.
extern "C" int ac_copy_rows(const uint8_t* frames, int64_t batch,
                            int64_t frame_pitch, int64_t row_pitch,
                            int64_t row_bytes, const int32_t* rows, int count,
                            uint8_t* dst, void* stream) {
  const size_t dst_pitch = (size_t)count * (size_t)row_bytes;
  for (int i = 0; i < count; ++i) {
    const cudaError_t e = cudaMemcpy2DAsync(
        dst + (size_t)i * (size_t)row_bytes, dst_pitch,
        frames + (int64_t)rows[i] * row_pitch, (size_t)frame_pitch,
        (size_t)row_bytes, (size_t)batch, cudaMemcpyHostToDevice,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
