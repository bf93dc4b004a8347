"""16-colour background, Floyd-Steinberg dithered:
image_print_16color_dithered_with_background, lib/video/ascii/scalar/foreground.c:752-846,
which image_print_color_simd falls through to for a truecolor terminal in
background mode (lib/video/ascii/sgr.c:413-436).

Each cell is one pixel. rgb_to_16color_dithered (lib/video/terminal/ansi.c:511-583)
takes the cells in raster order: a cell's value is its pixel plus the error
carried to it, in integers; its colour is the nearest of the 16 ANSI colours
(ansi.c:437-477: least squared distance, the first of equals) to the value
clamped to 0..255; the value less that colour's RGB is carried on as
(e * 7) / 16 to the right, (e * 3) / 16 below left, (e * 5) / 16 below and
(e * 1) / 16 below right, each quotient truncated toward zero as C divides,
and none past an edge. A cell writes a background SGR of its colour, a
foreground SGR of bright white (97) where the colour's luma
(77 R + 150 G + 29 B) / 256, with no rounding term, is under 127, else of
black (30), and the palette's glyph for the pixel's own BT.601 luminance.
Every row ends in a reset; rows are joined by newlines.

The dither runs here along anti-diagonal wavefronts t = x + 2y: a cell takes
error only from (x - 1, y), (x + 1, y - 1), (x, y - 1) and (x - 1, y - 1),
all on earlier wavefronts, and a sum of integers does not depend on the order
of its terms, so a wavefront's cells are computed at once and their colours
are the raster loop's.
"""

from __future__ import annotations

import functools

import numpy as np

from reference.palette import luminance_glyphs

ROWS_PER_CELL = 1
# Bytes of the program's records a cell, written once: rgb (3) and luma (1).
RECORD_BYTES_PER_CELL = 4

# ansi.c:442-459
COLOURS = np.array([
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
    (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
    (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
    (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
], dtype=np.int64)
WHITE, BLACK = 15, 0
RESET = b"\x1b[0m"
# the weights, in sixteenths, of the carries right, below left, below and below right
WEIGHTS = np.array([7, 3, 5, 1], np.int64)[:, None, None]


def sgr_fg(index: int) -> bytes:
    return b"\x1b[%dm" % (30 + index if index < 8 else 90 + index - 8)


def sgr_bg(index: int) -> bytes:
    return b"\x1b[%dm" % (40 + index if index < 8 else 100 + index - 8)


def nearest(values: np.ndarray) -> np.ndarray:
    """Index of the nearest of the 16 colours to each int [n, 3] in 0..255;
    of equals the first. |v - c|^2 less |v|^2, the same for every c, is
    |c|^2 - 2 v.c: exact in integers, so ties stay ties."""
    return ((COLOURS ** 2).sum(1) - 2 * values @ COLOURS.T).argmin(-1)


def div16(v: np.ndarray) -> np.ndarray:
    """v / 16 as C divides integers: toward zero."""
    return np.sign(v) * (np.abs(v) // 16)


def dither(pixels: np.ndarray) -> np.ndarray:
    """uint8 [rows, cells, 3] -> the 16-colour index of each cell.

    Wavefront t is row t of the skewed arrays: at [t, y] lies cell
    (y, x = t - 2y), so the carries right and below left go to row t + 1,
    below to t + 2, below right to t + 3, and those below to y + 1. A place
    with x outside the row holds no pixel, and its carry is zero."""
    h, w, _ = pixels.shape
    fronts = w + 2 * (h - 1)
    ys = np.arange(h)
    xs = np.arange(fronts)[:, None] - 2 * ys  # [t, y]
    inside = (xs >= 0) & (xs < w)
    src = np.zeros((fronts, h, 3), np.int64)
    src[inside] = pixels[np.nonzero(inside)[1], xs[inside]]
    err = np.zeros((fronts + 3, h, 3), np.int64)
    index = np.zeros((fronts, h), np.int64)
    for t in range(fronts):
        value = src[t] + err[t]
        index[t] = nearest(np.clip(value, 0, 255))
        e = (value - COLOURS[index[t]]) * inside[t, :, None]
        right, below_left, below, below_right = div16(e * WEIGHTS)
        err[t + 1] += right
        err[t + 1, 1:] += below_left[:-1]
        err[t + 2, 1:] += below[:-1]
        err[t + 3, 1:] += below_right[:-1]
    out = np.empty((h, w), np.int64)
    out[np.nonzero(inside)[1], xs[inside]] = index[inside]
    return out


@functools.lru_cache(maxsize=8)
def cell_bytes(palette: str) -> list[bytes]:
    """The bytes of a cell of colour c and luminance l at [c * 256 + l]."""
    glyphs = luminance_glyphs(palette)
    out = []
    for c in range(16):
        r, g, b = COLOURS[c].tolist()
        fg = WHITE if (77 * r + 150 * g + 29 * b) // 256 < 127 else BLACK
        out += [sgr_bg(c) + sgr_fg(fg) + glyph for glyph in glyphs]
    return out


def render(pixels: np.ndarray, palette: str) -> bytes:
    """uint8 [rows, cells, 3], already resized -> the frame's bytes."""
    h, w, _ = pixels.shape
    p = pixels.astype(np.int64)
    luma = np.clip((77 * p[..., 0] + 150 * p[..., 1] + 29 * p[..., 2] + 128) >> 8, 0, 255)
    table = cell_bytes(palette)
    cells = [table[k] for k in (dither(pixels) * 256 + luma).ravel().tolist()]
    return b"\n".join(b"".join(cells[y * w:(y + 1) * w]) + RESET for y in range(h))
