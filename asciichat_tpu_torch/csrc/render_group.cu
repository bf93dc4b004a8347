// K3: the server tick's render in one pass: composite gather, per-receiver
// colour filter, resize and cell records.
//
// Replaces the XLA graph asciichat_tpu/models/server.py::render_compute
// (server.py:58-91 with ops/filters.py:110-128): gather frames[cidx, sy, sx]
// with a black background, broadcast to C receivers, filter each, resize,
// then records_for_mode. Composite and resize are both pure selections, so
// the host composes them once per layout (ops/compositor.compose_maps) into
// [dst_h_px, dst_w] maps: each output pixel reads one source pixel, or black
// where the composed cidx is -1. The filter is per pixel, so filtering after
// the gather equals the reference's filter-then-resize; the background is
// filtered too, as in the reference.
//
// Bound: bytes, and small: the composite at terminal size is ~26k pixels, so
// a 9-receiver half-block tick reads ~52k sampled pixels (mostly from L2 after
// the first receiver) and writes the records. The composite and the resized
// batch never reach device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "records.cuh"

namespace ac {

// Receiver c's view of composed-map pixel (y, x).
struct GroupSource {
  const uint8_t* frames;
  int64_t h, w;
  const int32_t* cidx;  // [hpx, width]; -1 = background
  const int32_t* sy;
  const int32_t* sx;
  int width;
  const int32_t* tint;  // [C, 3]
  const uint8_t* fg_on_bg;
  const uint8_t* rainbow;
  const uint8_t* enabled;

  __device__ __forceinline__ Pixel load(int64_t c, int y, int x) const {
    const int64_t m = (int64_t)y * width + x;
    const int ci = cidx[m];
    Pixel p{0, 0, 0};
    if (ci >= 0) p = load_pixel(frames + pixel_offset(ci, h, w, sy[m], sx[m]));
    color_filter(p.r, p.g, p.b, tint[c * 3 + 0], tint[c * 3 + 1],
                 tint[c * 3 + 2], fg_on_bg[c] != 0, rainbow[c] != 0,
                 enabled[c] != 0);
    return p;
  }
};

}  // namespace ac

extern "C" int ac_render_group(int family, const uint8_t* frames, int64_t h,
                               int64_t w, const int32_t* cidx,
                               const int32_t* sy, const int32_t* sx, int hpx,
                               int width, const int32_t* tint,
                               const uint8_t* fg_on_bg, const uint8_t* rainbow,
                               const uint8_t* enabled, int64_t receivers,
                               const uint8_t* ramp_host, uint8_t* o0,
                               uint8_t* o1, uint8_t* o2, void* stream) {
  const ac::GroupSource src{frames, h,    w,        cidx,    sy,     sx,
                            width,  tint, fg_on_bg, rainbow, enabled};
  const ac::Records out{o0, o1, o2};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case ac::FAM_MONO:
      return ac::launch_records<ac::FAM_MONO>(src, ramp_host, out, receivers, hpx, width, s);
    case ac::FAM_RGB_LUMA:
      return ac::launch_records<ac::FAM_RGB_LUMA>(src, ramp_host, out, receivers, hpx, width, s);
    case ac::FAM_Q256_LUMA:
      return ac::launch_records<ac::FAM_Q256_LUMA>(src, ramp_host, out, receivers, hpx, width, s);
    case ac::FAM_Q16_KEY:
      return ac::launch_records<ac::FAM_Q16_KEY>(src, ramp_host, out, receivers, hpx, width, s);
    case ac::FAM_HB_RGB:
      return ac::launch_records<ac::FAM_HB_RGB>(src, ramp_host, out, receivers, hpx, width, s);
    case ac::FAM_HB_Q256:
      return ac::launch_records<ac::FAM_HB_Q256>(src, ramp_host, out, receivers, hpx, width, s);
    case ac::FAM_HB_Q16:
      return ac::launch_records<ac::FAM_HB_Q16>(src, ramp_host, out, receivers, hpx, width, s);
    default:
      return cudaErrorInvalidValue;
  }
}
