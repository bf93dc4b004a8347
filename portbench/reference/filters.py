"""Receivers' colour filters: apply_color_filter, lib/video/rgba/color_filter.c.

The registry is color_filter.c:23-142: a tint and whether the filter draws
dark on light. A filter greys each pixel with (77 R + 150 G + 29 B) >> 8,
without a rounding constant (color_filter.h:172-174), and colours it
(color_filter.c:257-271): tint * gray / 255, or (tint * (255 - gray) + 255
* gray) / 255 dark on light, in integers. ``none`` leaves the pixel as it
is. Rainbow's tint follows the clock and has no place here.
"""

from __future__ import annotations

import numpy as np

REGISTRY: dict[str, tuple[tuple[int, int, int], bool]] = {
    "none": ((0, 0, 0), False),
    "black": ((0, 0, 0), True),
    "white": ((255, 255, 255), False),
    "green": ((0, 255, 65), False),
    "magenta": ((255, 0, 255), False),
    "fuchsia": ((255, 0, 170), False),
    "orange": ((255, 136, 0), False),
    "teal": ((0, 221, 221), False),
    "cyan": ((0, 255, 255), False),
    "pink": ((255, 182, 193), False),
    "red": ((255, 51, 51), False),
    "yellow": ((255, 235, 153), False),
}


def apply(pixels: np.ndarray, name: str) -> np.ndarray:
    """uint8 [..., 3] through the filter ``name``."""
    if name == "none":
        return pixels
    tint, on_light = REGISTRY[name]
    p = pixels.astype(np.int64)
    gray = ((77 * p[..., 0] + 150 * p[..., 1] + 29 * p[..., 2]) >> 8)[..., None]
    t = np.array(tint, np.int64)
    out = (t * (255 - gray) + 255 * gray) // 255 if on_light else t * gray // 255
    return out.astype(np.uint8)
