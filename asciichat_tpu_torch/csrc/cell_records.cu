// K2: resize + per-mode cell records in one pass.
//
// Replaces the XLA graph asciichat_tpu/ops/cells.py::render_cells
// (pixel.resize_nn then records_for_mode, cells.py:51-95): K1's gather with
// the record epilogue of records.cuh fused in, templated on the mode family.
//
// Bound: bytes. Each cell reads one sampled pixel (two for half-block) and
// writes 1-4 record bytes; the epilogue is a few dozen integer operations
// (q16 is 16 squared distances), far below the card's integer rate. Fusing
// keeps the resized frame out of device memory: the records are the only
// output. The two half-block RGB modes (records top/bot are the resized rows
// themselves) are pure gathers and go through K1 instead (ops/cells.py).
//
// The gather reads every sector of each sampled row at 1080p, as K1's does
// (resize.cu): its floor is the sector floor (PERF.md, section 6). Staging
// the rows in shared memory (tools/k12_staged) was timed in turns with
// this kernel and lost.
#include <cuda_runtime.h>
#include <stdint.h>

#include "records.cuh"

namespace ac {

// Frame b at resize-table coordinates (sy[y], sx[x]).
struct ResizeSource {
  const uint8_t* frames;
  int64_t h, w;
  const int32_t* sy;
  const int32_t* sx;

  __device__ __forceinline__ Pixel load(int64_t b, int y, int x) const {
    return load_pixel(frames + pixel_offset(b, h, w, sy[y], sx[x]));
  }
};

}  // namespace ac

extern "C" int ac_cell_records(int family, const uint8_t* frames,
                               int64_t batch, int64_t h, int64_t w,
                               const int32_t* sy, int hpx, const int32_t* sx,
                               int width, const uint8_t* ramp_host,
                               uint8_t* o0, uint8_t* o1, uint8_t* o2,
                               void* stream) {
  const ac::ResizeSource src{frames, h, w, sy, sx};
  const ac::Records out{o0, o1, o2};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case ac::FAM_MONO:
      return ac::launch_records<ac::FAM_MONO>(src, ramp_host, out, batch, hpx, width, s);
    case ac::FAM_RGB_LUMA:
      return ac::launch_records<ac::FAM_RGB_LUMA>(src, ramp_host, out, batch, hpx, width, s);
    case ac::FAM_Q256_LUMA:
      return ac::launch_records<ac::FAM_Q256_LUMA>(src, ramp_host, out, batch, hpx, width, s);
    case ac::FAM_Q16_KEY:
      return ac::launch_records<ac::FAM_Q16_KEY>(src, ramp_host, out, batch, hpx, width, s);
    case ac::FAM_HB_Q256:
      return ac::launch_records<ac::FAM_HB_Q256>(src, ramp_host, out, batch, hpx, width, s);
    case ac::FAM_HB_Q16:
      return ac::launch_records<ac::FAM_HB_Q16>(src, ramp_host, out, batch, hpx, width, s);
    default:  // FAM_HB_RGB is K1's (see above)
      return cudaErrorInvalidValue;
  }
}
