// CPU test library over cells_math.cuh: the same per-element functions the
// kernels run, compiled by g++ and applied to arrays of RGB triples, so a
// test can check them against the plain PyTorch versions exhaustively.
// Built by runtime/kernel_build.cells_math_lib(); not used at run time.
#include <stdint.h>

#include "cells_math.cuh"

extern "C" {

void cm_luma(const uint8_t* rgb, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)ac::luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
}

void cm_mono_key(const uint8_t* rgb, int64_t n, const uint8_t* ramp,
                 uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)ac::mono_key(
        ramp, ac::luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]));
}

void cm_q256(const uint8_t* rgb, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)ac::q256(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
}

void cm_q16(const uint8_t* rgb, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)ac::q16(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
}

void cm_color_filter(const uint8_t* rgb, int64_t n, int tr, int tg, int tb,
                     int fg_on_bg, int rainbow, int enabled, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    ac::color_filter(r, g, b, tr, tg, tb, fg_on_bg != 0, rainbow != 0,
                     enabled != 0);
    out[3 * i] = (uint8_t)r;
    out[3 * i + 1] = (uint8_t)g;
    out[3 * i + 2] = (uint8_t)b;
  }
}

int cm_hb_bot_row(int r, int hpx) { return ac::hb_bot_row(r, hpx); }

int64_t cm_pixel_offset(int64_t b, int64_t h, int64_t w, int64_t y,
                        int64_t x) {
  return ac::pixel_offset(b, h, w, y, x);
}

}  // extern "C"
