"""The control: the reference with its pixels carried at 16 bits (RGB565).

Ingest paces these cells, so the step that would tempt a later change is to
move fewer bytes a pixel across the host link: RGB565 carries 5 bits of red,
6 of green and 5 of blue, a third less than the 24 the configurations state,
and widens them back by repeating the high bits. Put in the program's place,
it has to come out as not correct.
"""

from __future__ import annotations

import numpy as np

from reference.render import Reference


def rgb565(pixels: np.ndarray) -> np.ndarray:
    p = pixels.astype(np.uint16)
    r, g, b = p[..., 0] >> 3, p[..., 1] >> 2, p[..., 2] >> 3
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)],
                    -1).astype(np.uint8)


class Rgb565Reference(Reference):
    def resize(self, frame: np.ndarray) -> np.ndarray:
        return rgb565(super().resize(frame))
