"""The server's grid composite and the geometry of a receiver's frame.

calculate_optimal_grid_layout and create_multi_source_composite,
src/server/stream.c:523-779, in float32 as the C computes them: the
composite of a terminal ``width`` x ``height`` cells is ``width`` x
``2 * height`` pixels (stream.c:673-679). Of the layouts whose cells are at
least 20 x 10 and that leave no more than a row's worth of cells empty, the
one that fills most of each cell with a picture of the sources' mean aspect
wins (first wins on a tie; one source alone fills the terminal). Sources take
the cells row by row, at most 9 of them. Each is fitted whole into its cell
(the fit that stays inside, rounded as (int)(x + 0.5f)), centred, resized by
the 16.16 fixed-point nearest neighbour and clipped to its cell and the
composite; pixels no source covers are black.

The composite then goes through the receiver's conversion with its height
doubled for half-block terminals (stream.c:831; ascii.c:230 doubles it again
into pixel rows), so each output pixel reads one pixel of one source.
"""

from __future__ import annotations

import numpy as np

from reference import geometry

MAX_SOURCES = 9
MIN_CELL_W, MIN_CELL_H = 20, 10
F32 = np.float32


def grid_layout(sizes: list[tuple[int, int]], width: int, height: int) -> tuple[int, int]:
    """(columns, rows) of the grid for sources of (w, h) pixels in a terminal
    of ``width`` x ``height`` cells."""
    n = len(sizes)
    if n <= 1:
        return n, n
    aspects = [F32(w) / F32(h) for w, h in sizes if h > 0]
    mean = sum(aspects, F32(0.0)) / F32(len(aspects)) if aspects else F32(1.6)
    best, best_fill = (1, n), F32(0.0)
    for cols in range(1, n + 1):
        rows = -(-n // cols)
        if cols * rows - n > cols:
            continue
        cell_w, cell_h = width // cols, height // rows
        if cell_w < MIN_CELL_W or cell_h < MIN_CELL_H:
            continue
        if mean > F32(cell_w) / (F32(cell_h) * geometry.CHAR_ASPECT):
            fit_w, fit_h = cell_w, int(F32(cell_w) / mean / geometry.CHAR_ASPECT)
        else:
            fit_w, fit_h = int(F32(cell_h) * geometry.CHAR_ASPECT * mean), cell_h
        fill = F32(min(fit_w, cell_w) * min(fit_h, cell_h)) / F32(cell_w * cell_h)
        if fill > best_fill:
            best, best_fill = (cols, rows), fill
    return best


def composite_maps(sizes: list[tuple[int, int]], width: int, height: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source, source row, source column) of each composite pixel, int64
    [2 * height, width]; source -1 where no source is drawn."""
    comp_w, comp_h = width, 2 * height
    src = np.full((comp_h, comp_w), -1, np.int64)
    sy = np.zeros((comp_h, comp_w), np.int64)
    sx = np.zeros((comp_h, comp_w), np.int64)
    cols, rows = grid_layout(sizes, width, height)
    if cols == 0:
        return src, sy, sx
    cell_w, cell_h = comp_w // cols, comp_h // rows
    for i, (w, h) in enumerate(sizes[:MAX_SOURCES]):
        if cell_w <= 0 or cell_h <= 0 or w <= 0 or h <= 0:
            continue
        aspect = F32(w) / F32(h)
        if aspect > F32(cell_w) / F32(cell_h):
            fit_w, fit_h = cell_w, int(F32(cell_w) / aspect + F32(0.5))
        else:
            fit_w, fit_h = int(F32(cell_h) * aspect + F32(0.5)), cell_h
        if fit_w <= 0 or fit_h <= 0:
            continue
        left, top = (i % cols) * cell_w, (i // cols) * cell_h
        ys = top + (cell_h - fit_h) // 2 + np.arange(fit_h)
        xs = left + (cell_w - fit_w) // 2 + np.arange(fit_w)
        in_y = (ys >= top) & (ys < top + cell_h) & (ys >= 0) & (ys < comp_h)
        in_x = (xs >= left) & (xs < left + cell_w) & (xs >= 0) & (xs < comp_w)
        at = np.ix_(ys[in_y], xs[in_x])
        src[at] = i
        sy[at] = geometry.resize_indices(h, fit_h)[in_y][:, None]
        sx[at] = geometry.resize_indices(w, fit_w)[in_x][None, :]
    return src, sy, sx


def receiver_maps(sizes: list[tuple[int, int]], width: int, height: int, rows_per_cell: int,
                  padding: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(source, row, column) maps of a receiver's frame, [pixel rows, cells
    wide], and its (left, top) padding: the composite fitted into the
    terminal with its height doubled for half-block (rows_per_cell 2)."""
    src, sy, sx = composite_maps(sizes, width, height)
    cells_w, pixel_rows, pad_w, pad_h = geometry.render_geometry(
        width, 2 * height, width, height * rows_per_cell, rows_per_cell, True, padding)
    ry = geometry.resize_indices(2 * height, pixel_rows)[:, None]
    rx = geometry.resize_indices(width, cells_w)[None, :]
    return src[ry, rx], sy[ry, rx], sx[ry, rx], pad_w, pad_h
