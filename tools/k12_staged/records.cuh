// The staged K2's (cell_records.cu beside this file) per-mode cell-record
// body, the package's csrc/records.cuh rewritten as the epilogue of the
// row-staging kernel (row_stage.cuh): the staged pixel (two for the
// half-block families) of one cell in, the cell's 1-4 record bytes out,
// into the record stage that the kernel stores as 16-byte words. It
// replaces asciichat_tpu/ops/cells.py::records_for_mode (cells.py:51-82)
// after the gather. Bound: bytes, at the sector floor of the rows K2
// samples; the body is a few dozen integer operations a cell, which the
// staging lets run while the next rows are copied in. K3 (render_group.cu)
// has a body of its own, with the same per-element math from
// cells_math.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cells_math.cuh"
#include "row_stage.cuh"

namespace ac {

// The palette's luma->key ramp rides by value in the kernel's parameters,
// which live in the constant bank: no module state, nothing to upload, and
// two palettes on two streams cannot race.
struct Ramp {
  uint8_t v[64];
};

// Bytes a cell of a family's record k (0: the family has no record k).
AC_HD constexpr int record_bytes(int fam, int k) {
  return k == 0 ? ((fam == FAM_RGB_LUMA || fam == FAM_HB_RGB) ? 3 : 1)
         : k == 1 ? (fam == FAM_MONO ? 0 : (fam == FAM_HB_RGB ? 3 : 1))
                  : ((fam == FAM_HB_Q256 || fam == FAM_HB_Q16) ? 1 : 0);
}

// The records of family FAM over `hpx` resized pixel rows: an item is a cell
// row, which samples pixel row r, or rows 2r and hb_bot_row(r) in the
// half-block families.
template <int FAM>
struct RecordEpilogue {
  static constexpr int kRows = is_halfblock(FAM) ? 2 : 1;
  __host__ __device__ static constexpr int bpc(int o) { return record_bytes(FAM, o); }
  Ramp ramp;
  int rows, hpx;
  uint8_t* out[kMaxOutputs];

  __device__ __forceinline__ int row_of(int r, int k) const {
    if constexpr (is_halfblock(FAM)) return k == 0 ? 2 * r : hb_bot_row(r, hpx);
    return r;
  }

  __device__ __forceinline__ void cell(const Pixel* px, uint8_t* const* o,
                                       int i) const {
    if constexpr (is_halfblock(FAM)) {
      const Pixel top = px[0];
      const Pixel bot = px[kRows - 1];
      if constexpr (FAM == FAM_HB_RGB) {
        store_rgb(o[0], i, top);
        store_rgb(o[1], i, bot);
      } else {
        if constexpr (FAM == FAM_HB_Q16) {
          o[0][i] = (uint8_t)q16(top.r, top.g, top.b);
          o[1][i] = (uint8_t)q16(bot.r, bot.g, bot.b);
        } else {
          o[0][i] = (uint8_t)q256(top.r, top.g, top.b);
          o[1][i] = (uint8_t)q256(bot.r, bot.g, bot.b);
        }
        o[2][i] =
            (uint8_t)((top.r | top.g | top.b | bot.r | bot.g | bot.b) == 0);
      }
    } else {
      const Pixel p = px[0];
      const int y = luma(p.r, p.g, p.b);
      if constexpr (FAM == FAM_MONO) {
        o[0][i] = (uint8_t)mono_key(ramp.v, y);
      } else if constexpr (FAM == FAM_RGB_LUMA) {
        store_rgb(o[0], i, p);
        o[1][i] = (uint8_t)y;
      } else if constexpr (FAM == FAM_Q256_LUMA) {
        o[0][i] = (uint8_t)q256(p.r, p.g, p.b);
        o[1][i] = (uint8_t)y;
      } else {  // FAM_Q16_KEY
        o[0][i] = (uint8_t)q16(p.r, p.g, p.b);
        o[1][i] = (uint8_t)mono_key(ramp.v, y);
      }
    }
  }
};

template <int FAM>
cudaError_t launch_records(const RowSource& src, const uint8_t* ramp_host,
                           uint8_t* o0, uint8_t* o1, uint8_t* o2, int hpx,
                           cudaStream_t stream) {
  RecordEpilogue<FAM> epi;
  for (int k = 0; k < 64; ++k) epi.ramp.v[k] = ramp_host[k];
  epi.rows = is_halfblock(FAM) ? (hpx + 1) / 2 : hpx;
  epi.hpx = hpx;
  uint8_t* const outs[kMaxOutputs] = {o0, o1, o2};
  for (int k = 0; k < kMaxOutputs; ++k) epi.out[k] = record_bytes(FAM, k) ? outs[k] : nullptr;
  return launch_row_stage(src, epi, stream);
}

}  // namespace ac
