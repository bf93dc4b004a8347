"""Truecolor foreground: image_print_color, lib/video/ascii/scalar/foreground.c:195-308.

Each cell is one pixel. Its glyph is the palette's glyph for the pixel's
BT.601 luminance, (77 R + 150 G + 29 B + 128) >> 8. A single-byte glyph is
preceded by a 24-bit foreground SGR only where the colour differs from that
of the last single-byte-glyph cell before it (the first always has one); a
multi-byte glyph always has one and leaves that colour as it was. Rows end
in a newline, the frame in one reset.
"""

from __future__ import annotations

import numpy as np

from reference.palette import luminance_glyphs

ROWS_PER_CELL = 1
# Bytes of the program's records a cell, written once: rgb (3) and luma (1).
RECORD_BYTES_PER_CELL = 4

SGR_FG = b"\x1b[38;2;%d;%d;%dm"
RESET = b"\x1b[0m"


def luminance(pixels: np.ndarray) -> np.ndarray:
    p = pixels.astype(np.int64)
    return np.clip((77 * p[..., 0] + 150 * p[..., 1] + 29 * p[..., 2] + 128) >> 8, 0, 255)


def render(pixels: np.ndarray, palette: str) -> bytes:
    """uint8 [rows, cells, 3], already resized -> the frame's bytes."""
    glyphs = luminance_glyphs(palette)
    h, w, _ = pixels.shape
    flat = pixels.reshape(-1, 3).astype(np.int64)
    luma = luminance(flat)
    colour = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    single = np.array([len(g) == 1 and g[0] < 128 for g in glyphs])[luma]
    # the colour of the last single-byte-glyph cell before each cell, -1 if none
    marks = np.where(single, np.arange(colour.size), -1)
    before = np.concatenate(([-1], np.maximum.accumulate(marks)[:-1]))
    last = np.where(before >= 0, colour[np.maximum(before, 0)], -1)
    sgr = (~single | (last != colour)).tolist()
    rgb, luma = flat.tolist(), luma.tolist()
    out = []
    for i in range(h * w):
        if i and i % w == 0:
            out.append(b"\n")
        if sgr[i]:
            out.append(SGR_FG % tuple(rgb[i]))
        out.append(glyphs[luma[i]])
    out.append(RESET)
    return b"".join(out)
