"""Truecolor half-blocks: rgb_to_truecolor_halfblocks_scalar,
lib/video/ascii/scalar/halfblock.c:48-165.

A cell row takes two pixel rows (an odd last row is its own bottom). A run
of cells with equal top and bottom colours is one upper half block (U+2580)
with the top as foreground and the bottom as background, each SGR written
only where it changed within the row, then the rest of the run as a repeat
(ESC[nb) where that is shorter (output_buffer.c:148-154), else as glyphs. A
run whose top and bottom are both black is spaces, after a reset if a colour
was set. Every row ends in a reset; rows are joined by newlines.
"""

from __future__ import annotations

import numpy as np

ROWS_PER_CELL = 2
# Bytes of the program's records a cell, written once: top rgb (3), bottom rgb (3).
RECORD_BYTES_PER_CELL = 6

SGR_FG = b"\x1b[38;2;%d;%d;%dm"
SGR_BG = b"\x1b[48;2;%d;%d;%dm"
RESET = b"\x1b[0m"
HALF_BLOCK = "▀".encode()


def _rgb(c: int) -> tuple[int, int, int]:
    return c >> 16, (c >> 8) & 255, c & 255


def repeat_is_shorter(run: int) -> bool:
    extra = run - 1
    return run > 2 and extra > len(str(extra)) + 3


def render(pixels: np.ndarray, palette: str) -> bytes:
    """uint8 [pixel rows, cells, 3], already resized -> the frame's bytes
    (the palette is unused: every cell is a half block or a space)."""
    p = pixels.astype(np.int64)
    colour = (p[..., 0] << 16) | (p[..., 1] << 8) | p[..., 2]
    top = colour[0::2]
    bot = colour[1::2]
    if bot.shape[0] < top.shape[0]:
        bot = np.concatenate([bot, colour[-1:]])
    w = colour.shape[1]
    lines = []
    for t_row, b_row in zip(top, bot):
        change = np.flatnonzero((t_row[1:] != t_row[:-1]) | (b_row[1:] != b_row[:-1])) + 1
        starts = [0, *change.tolist()]
        ends = [*change.tolist(), w]
        tops, bots = t_row.tolist(), b_row.tolist()
        line = []
        fg = bg = None
        for x, end in zip(starts, ends):
            t, b, run = tops[x], bots[x], end - x
            if t == 0 and b == 0:
                if fg is not None or bg is not None:
                    line.append(RESET)
                    fg = bg = None
                line.append(b" " * run)
                continue
            if fg != t:
                line.append(SGR_FG % _rgb(t))
                fg = t
            if bg != b:
                line.append(SGR_BG % _rgb(b))
                bg = b
            line.append(HALF_BLOCK)
            line.append(b"\x1b[%db" % (run - 1) if repeat_is_shorter(run)
                        else HALF_BLOCK * (run - 1))
        line.append(RESET)
        lines.append(b"".join(line))
    return b"\n".join(lines)
