// K2 as a row-staging kernel (row_stage.cuh): the design measured against
// the package's K2 (asciichat_tpu_torch/csrc/cell_records.cu) and not
// shipped. It takes the package's C entry point, ac_cell_records.
//
// The same function: the XLA graph asciichat_tpu/ops/cells.py::render_cells
// (pixel.resize_nn then records_for_mode, cells.py:51-95): K1's gather with
// the record epilogue of records.cuh fused in, templated on the mode family.
//
// Bound: bytes, at the sector floor. Each cell reads one sampled pixel (two
// for half-block) and writes 1-4 record bytes; the epilogue is a few dozen
// integer operations (q16 is 16 squared distances), far below the card's
// integer rate. At 1080p a column steps 28.4 bytes, under a sector, so the
// memory moves every sector of each sampled row: 42.0 MB of rows and 5.92 MB
// of truecolor records at B=128 -> 57x203 (47.95 MB, 14.31 us at 3.35
// TB/s). The row-staging kernel (row_stage.cuh) streams those rows into
// shared memory a few rows ahead of the epilogue and stores the records as
// 16-byte words; fusing keeps the resized frame out of device memory. The
// two half-block RGB modes (records top/bot are the resized rows
// themselves) are pure gathers and go through K1 instead (ops/cells.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "records.cuh"

extern "C" int ac_cell_records(int family, const uint8_t* frames,
                               int64_t batch, int64_t h, int64_t w,
                               const int32_t* sy, int hpx, const int32_t* sx,
                               int width, const uint8_t* ramp_host,
                               uint8_t* o0, uint8_t* o1, uint8_t* o2,
                               void* stream) {
  const ac::RowSource src{frames, batch, h, w, sy, sx, width};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case ac::FAM_MONO:
      return ac::launch_records<ac::FAM_MONO>(src, ramp_host, o0, o1, o2, hpx, s);
    case ac::FAM_RGB_LUMA:
      return ac::launch_records<ac::FAM_RGB_LUMA>(src, ramp_host, o0, o1, o2, hpx, s);
    case ac::FAM_Q256_LUMA:
      return ac::launch_records<ac::FAM_Q256_LUMA>(src, ramp_host, o0, o1, o2, hpx, s);
    case ac::FAM_Q16_KEY:
      return ac::launch_records<ac::FAM_Q16_KEY>(src, ramp_host, o0, o1, o2, hpx, s);
    case ac::FAM_HB_Q256:
      return ac::launch_records<ac::FAM_HB_Q256>(src, ramp_host, o0, o1, o2, hpx, s);
    case ac::FAM_HB_Q16:
      return ac::launch_records<ac::FAM_HB_Q16>(src, ramp_host, o0, o1, o2, hpx, s);
    default:  // FAM_HB_RGB is K1's (see above)
      return cudaErrorInvalidValue;
  }
}
