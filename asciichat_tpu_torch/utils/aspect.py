"""Aspect-ratio fitting with terminal cell correction.

Byte-exact re-derivation of lib/util/aspect_ratio.c. CHAR_ASPECT = 2.0
(terminal cells are ~2x taller than wide); ROUND(x) = (int)(0.5f + x)
(util/math.h:53). All float math is done in float32 to match the C code.
"""

from __future__ import annotations

import numpy as np

CHAR_ASPECT = np.float32(2.0)
MIN_DIMENSION = 1


def _round_c(x: np.float32) -> int:
    """(int)(0.5f + x) — truncation after adding 0.5f (util/math.h:53)."""
    return int(np.float32(0.5) + np.float32(x))


def _calc_width_from_height(height: int, img_w: int, img_h: int) -> int:
    if img_h == 0:
        return MIN_DIMENSION
    width = np.float32(height) * np.float32(img_w) / np.float32(img_h) * CHAR_ASPECT
    result = _round_c(width)
    return result if result > 0 else MIN_DIMENSION


def _calc_height_from_width(width: int, img_w: int, img_h: int) -> int:
    if img_w == 0:
        return MIN_DIMENSION
    height = (np.float32(width) / CHAR_ASPECT) * np.float32(img_h) / np.float32(img_w)
    result = _round_c(height)
    return result if result > 0 else MIN_DIMENSION


def aspect_ratio(
    img_w: int, img_h: int, width: int, height: int, stretch: bool
) -> tuple[int, int]:
    """Fit (img_w, img_h) pixels into (width, height) cells (aspect_ratio.c:69-91)."""
    if img_w <= 0 or img_h <= 0:
        return MIN_DIMENSION, MIN_DIMENSION
    if stretch:
        return width, height

    width_from_height = _calc_width_from_height(height, img_w, img_h)
    height_from_width = _calc_height_from_width(width, img_w, img_h)
    if width_from_height <= width:
        out_w, out_h = width_from_height, height
    else:
        out_w, out_h = width, height_from_width
    return max(out_w, MIN_DIMENSION), max(out_h, MIN_DIMENSION)


def aspect_ratio2(img_w: int, img_h: int, target_w: int, target_h: int) -> tuple[int, int]:
    """Pixel-space CONTAIN fit without cell correction (aspect_ratio.c:95-142)."""
    if img_w <= 0 or img_h <= 0 or target_w <= 0 or target_h <= 0:
        return MIN_DIMENSION, MIN_DIMENSION
    img_aspect = np.float32(img_w) / np.float32(img_h)
    height_if_fill_width = int(np.float32(target_w) / img_aspect)
    width_if_fill_height = int(np.float32(target_h) * img_aspect)
    if height_if_fill_width <= target_h:
        out_w, out_h = target_w, height_if_fill_width
    else:
        out_w, out_h = width_if_fill_height, target_h
    return max(out_w, MIN_DIMENSION), max(out_h, MIN_DIMENSION)


def fit_dimensions_pixel(
    img_w: int, img_h: int, max_w: int, max_h: int
) -> tuple[int, int]:
    """calculate_fit_dimensions_pixel (aspect_ratio.c:146-195): +0.5f rounding."""
    if img_w <= 0 or img_h <= 0:
        return max_w, max_h
    src_aspect = np.float32(img_w) / np.float32(img_h)
    height_if_fill_w = int(np.float32(max_w) / src_aspect + np.float32(0.5))
    width_if_fill_h = int(np.float32(max_h) * src_aspect + np.float32(0.5))
    if height_if_fill_w <= max_h:
        out_w, out_h = max_w, height_if_fill_w
    else:
        out_w, out_h = width_if_fill_h, max_h
    # clamp order matters and must match the C (aspect_ratio.c:185-193):
    # UPPER bound first, then the >=1 floor — so a degenerate max dim
    # (collapsed window mid-negotiation) yields 1 like the reference, not a
    # 0 that detonates as ZeroDivisionError inside resize_indices later
    out_w = max(min(out_w, max_w), 1)
    out_h = max(min(out_h, max_h), 1)
    return out_w, out_h


def resize_indices(src: int, dst: int) -> np.ndarray:
    """Fixed-point 16.16 nearest-neighbour source indices (image.c:293-326).

    ratio = ((src << 16) / dst) + 1 (integer division); src_i = (i*ratio) >> 16,
    clamped to src-1.
    """
    if src <= 0 or dst <= 0:
        # the reference error-returns on degenerate dims (image.c guards +
        # SET_ERRNO); OverflowError from np.uint32(-1) / ZeroDivisionError
        # here were unhandleable by the protocol-violation paths
        raise ValueError(f"resize_indices: degenerate dims src={src} dst={dst}")
    ratio = np.uint32((((src << 16) // dst) + 1) & 0xFFFFFFFF)
    # C multiplies in uint32 with wraparound (image.c:300,315).
    with np.errstate(over="ignore"):
        idx = (np.arange(dst, dtype=np.uint32) * ratio) >> np.uint32(16)
    return np.minimum(idx, np.uint32(src - 1)).astype(np.int32)
