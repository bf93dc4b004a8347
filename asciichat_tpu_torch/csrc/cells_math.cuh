// Per-element math of the render path, shared by the Hopper kernels
// (resize.cu, cell_records.cu, render_group.cu) and by a g++-built CPU test
// library (cells_math_host.cpp). One definition of every formula, so the
// exhaustive CPU test over all 2^24 RGB triples checks the code the card runs.
//
// Every function widens to int before arithmetic, as the JAX reference does
// (asciichat_tpu/ops/pixel.py:99,111,122 and ops/filters.py:119): uint8
// arithmetic would wrap. All operands are non-negative, so C's truncating `/`
// equals the reference's floor division.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define AC_HD __host__ __device__ __forceinline__
#else
#define AC_HD inline
#endif

namespace ac {

// Record families of the per-mode epilogue (asciichat_tpu/ops/cells.py:51-82).
// The Python side keeps the same numbering in ops/cells.py MODE_FAMILY.
enum Family : int {
  FAM_MONO = 0,       // mono:                                  key
  FAM_RGB_LUMA = 1,   // truecolor_fg, 16color_dithered(_bg):   rgb, luma
  FAM_Q256_LUMA = 2,  // 256color:                              color, luma
  FAM_Q16_KEY = 3,    // 16color:                               color, key
  FAM_HB_RGB = 4,     // halfblock_truecolor, halfblock_mono:   top, bot
  FAM_HB_Q256 = 5,    // halfblock_256:                         fg, bg, transparent
  FAM_HB_Q16 = 6,     // halfblock_16:                          fg, bg, transparent
};

AC_HD constexpr bool is_halfblock(int fam) {
  return fam == FAM_HB_RGB || fam == FAM_HB_Q256 || fam == FAM_HB_Q16;
}

// 179 = 70% of 255, the rainbow filter's gray pre-boost (color_filter.c:301).
constexpr int kRainbowMinBrightness = 179;

AC_HD int iabs(int v) { return v < 0 ? -v : v; }

// Byte offset of pixel (b, y, x) in a C-contiguous uint8 [B, H, W, 3] batch.
// 64-bit: 128 x 1080 x 1920 x 3 is already 7.96e8 bytes.
AC_HD int64_t pixel_offset(int64_t b, int64_t h, int64_t w, int64_t y,
                           int64_t x) {
  return ((b * h + y) * w + x) * 3;
}

// ITU-R BT.601 luma with rounding, clamped (ops/pixel.py:96-101).
AC_HD int luma(int r, int g, int b) {
  const int y = (77 * r + 150 * g + 29 * b + 128) >> 8;
  return y < 0 ? 0 : (y > 255 ? 255 : y);
}

// Mono run key: ramp[luma >> 2] (ops/pixel.py:104-106); ramp is uint8[64].
AC_HD int mono_key(const uint8_t* ramp, int y) { return ramp[y >> 2]; }

// 6x6x6 cube + 24-step gray ramp (ops/pixel.py:109-117).
AC_HD int q256(int r, int g, int b) {
  const int avg = (r + g + b) / 3;
  const int gray_diff = iabs(r - avg) + iabs(g - avg) + iabs(b - avg);
  if (gray_diff < 30) return 232 + (avg * 23) / 255;
  return 16 + (r * 5 / 255) * 36 + (g * 5 / 255) * 6 + (b * 5 / 255);
}

// Nearest of the 16 ANSI colours (ops/pixel.py:21-30,120-129). The strict `<`
// keeps the first colour on a tie, as the reference's argmin does.
AC_HD int q16(int r, int g, int b) {
  const int pal[16][3] = {
      {0, 0, 0},       {128, 0, 0},   {0, 128, 0},   {128, 128, 0},
      {0, 0, 128},     {128, 0, 128}, {0, 128, 128}, {192, 192, 192},
      {128, 128, 128}, {255, 0, 0},   {0, 255, 0},   {255, 255, 0},
      {0, 0, 255},     {255, 0, 255}, {0, 255, 255}, {255, 255, 255},
  };
  int best = 0;
  int best_d = 1 << 30;
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int i = 0; i < 16; ++i) {
    const int dr = r - pal[i][0], dg = g - pal[i][1], db = b - pal[i][2];
    const int d = dr * dr + dg * dg + db * db;
    if (d < best_d) {
      best_d = d;
      best = i;
    }
  }
  return best;
}

// Half-block pairing: cell row r shows pixel rows 2r (top) and 2r+1 (bottom);
// an odd pixel height repeats its last row (ops/pixel.py:132-140).
AC_HD int hb_bot_row(int r, int hpx) {
  const int y = 2 * r + 1;
  return y < hpx ? y : hpx - 1;
}

// The colour filter's gray (ops/filters.py:110): (77,150,29)>>8 with no
// rounding constant. It does not depend on the receiver.
AC_HD int filter_gray(int r, int g, int b) { return (77 * r + 150 * g + 29 * b) >> 8; }

// The rest of the per-receiver colour filter (ops/filters.py:111-128) for a
// pixel whose filter_gray is `gray`: the rainbow pre-boost, then colourise
// on the background (fg_on_bg) or on black. A disabled receiver passes
// through.
AC_HD void colorize(int& r, int& g, int& b, int gray, int tr, int tg, int tb,
                    bool fg_on_bg, bool rainbow, bool enabled) {
  if (!enabled) return;
  if (rainbow)
    gray = kRainbowMinBrightness + (gray * (255 - kRainbowMinBrightness)) / 255;
  if (fg_on_bg) {
    r = (tr * (255 - gray) + 255 * gray) / 255;
    g = (tg * (255 - gray) + 255 * gray) / 255;
    b = (tb * (255 - gray) + 255 * gray) / 255;
  } else {
    r = (tr * gray) / 255;
    g = (tg * gray) / 255;
    b = (tb * gray) / 255;
  }
}

// Per-receiver colour filter (ops/filters.py:110-128).
AC_HD void color_filter(int& r, int& g, int& b, int tr, int tg, int tb,
                        bool fg_on_bg, bool rainbow, bool enabled) {
  colorize(r, g, b, filter_gray(r, g, b), tr, tg, tb, fg_on_bg, rainbow, enabled);
}

}  // namespace ac
