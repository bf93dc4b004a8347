"""256-colour half-blocks: rgb_to_256color_halfblocks_scalar,
lib/video/ascii/scalar/halfblock.c:416-524.

A cell row takes two pixel rows (an odd last row is its own bottom). Each
pixel becomes an xterm 256-colour index (ansi.c:360-379): a grey ramp entry,
232 + avg * 23 / 255, where the channels lie within 30 of their mean in
sum, else the 6x6x6 cube entry 16 + 36 (R*5/255) + 6 (G*5/255) + B*5/255.
A run of cells with equal top and bottom indices is one upper half block
with the top as foreground and the bottom as background, each SGR
(ESC[38;5;nm, ESC[48;5;nm) written only where it changed within the row,
then the rest of the run as a repeat (ESC[nb) where that is shorter, else as
glyphs. A run whose first cell is black on top and bottom, in RGB, is spaces,
after a reset if a colour was set. Every row ends in a reset; rows are
joined by newlines.
"""

from __future__ import annotations

import numpy as np

ROWS_PER_CELL = 2
# Bytes of the program's records a cell, written once: fg, bg, transparent.
RECORD_BYTES_PER_CELL = 3

SGR_FG = b"\x1b[38;5;%dm"
SGR_BG = b"\x1b[48;5;%dm"
RESET = b"\x1b[0m"
HALF_BLOCK = "▀".encode()


def index256(pixels: np.ndarray) -> np.ndarray:
    """The xterm 256-colour index of each pixel of uint8 [..., 3]."""
    p = pixels.astype(np.int64)
    avg = p.sum(-1) // 3
    grey = np.abs(p - avg[..., None]).sum(-1) < 30
    cube = 16 + 36 * (p[..., 0] * 5 // 255) + 6 * (p[..., 1] * 5 // 255) + p[..., 2] * 5 // 255
    return np.where(grey, 232 + avg * 23 // 255, cube)


def repeat_is_shorter(run: int) -> bool:
    extra = run - 1
    return run > 2 and extra > len(str(extra)) + 3


def render(pixels: np.ndarray, palette: str) -> bytes:
    """uint8 [pixel rows, cells, 3], already resized -> the frame's bytes
    (the palette is unused)."""
    top_px, bot_px = pixels[0::2], pixels[1::2]
    if bot_px.shape[0] < top_px.shape[0]:
        bot_px = np.concatenate([bot_px, pixels[-1:]])
    top, bot = index256(top_px), index256(bot_px)
    black = ~(top_px.any(-1) | bot_px.any(-1))
    w = pixels.shape[1]
    lines = []
    for t_row, b_row, k_row in zip(top, bot, black):
        change = np.flatnonzero((t_row[1:] != t_row[:-1]) | (b_row[1:] != b_row[:-1])) + 1
        starts = [0, *change.tolist()]
        ends = [*change.tolist(), w]
        tops, bots, blacks = t_row.tolist(), b_row.tolist(), k_row.tolist()
        line = []
        fg = bg = None
        for x, end in zip(starts, ends):
            run = end - x
            if blacks[x]:
                if fg is not None or bg is not None:
                    line.append(RESET)
                    fg = bg = None
                line.append(b" " * run)
                continue
            if fg != tops[x]:
                line.append(SGR_FG % tops[x])
                fg = tops[x]
            if bg != bots[x]:
                line.append(SGR_BG % bots[x])
                bg = bots[x]
            line.append(HALF_BLOCK)
            line.append(b"\x1b[%db" % (run - 1) if repeat_is_shorter(run)
                        else HALF_BLOCK * (run - 1))
        line.append(RESET)
        lines.append(b"".join(line))
    return b"\n".join(lines)
