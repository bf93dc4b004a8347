"""Geometry of one conversion: aspect fit, resize indices, padding.

aspect_ratio.c:69-91 in float32 with ROUND(x) = (int)(0.5f + x)
(util/math.h:53); the 16.16 fixed-point nearest-neighbour indices of
image.c:293-326; the padding of ascii.c:238-253, 457-517 and 902-941.
"""

from __future__ import annotations

import numpy as np

CHAR_ASPECT = np.float32(2.0)


def _round_c(x) -> int:
    return int(np.float32(0.5) + np.float32(x))


def fit_cells(src_w: int, src_h: int, width: int, height: int) -> tuple[int, int]:
    """(cells wide, cells high) of a src_w x src_h picture in a width x height
    terminal, the aspect kept (terminal cells twice as tall as wide)."""
    if src_w <= 0 or src_h <= 0:
        return 1, 1
    from_h = _round_c(np.float32(height) * np.float32(src_w) / np.float32(src_h) * CHAR_ASPECT)
    from_w = _round_c((np.float32(width) / CHAR_ASPECT) * np.float32(src_h) / np.float32(src_w))
    from_h, from_w = max(from_h, 1), max(from_w, 1)
    if from_h <= width:
        return from_h, height
    return width, from_w


def render_geometry(src_w: int, src_h: int, width: int, height: int,
                    rows_per_cell: int, keep_aspect: bool, padding: bool
                    ) -> tuple[int, int, int, int]:
    """(cells wide, pixel rows, left padding, top padding) of one conversion.
    ``rows_per_cell`` is 2 for half-block modes, which sample two pixel rows
    a cell row; the padding is counted in cell rows."""
    cells_w, cells_h = fit_cells(src_w, src_h, width, height) if keep_aspect else (width, height)
    pad_w = pad_h = 0
    if keep_aspect and padding:
        pad_w = max(0, (width - cells_w) // 2)
        pad_h = max(0, (height - cells_h) // 2)
    return cells_w, cells_h * rows_per_cell, pad_w, pad_h


def resize_indices(src: int, dst: int) -> np.ndarray:
    """Source index of each of ``dst`` samples: ratio = (src << 16) / dst + 1,
    index = (i * ratio) >> 16 in uint32 arithmetic, at most src - 1."""
    if src <= 0 or dst <= 0:
        raise ValueError(f"degenerate resize {src} -> {dst}")
    ratio = ((src << 16) // dst + 1) & 0xFFFFFFFF
    idx = [((i * ratio) & 0xFFFFFFFF) >> 16 for i in range(dst)]
    return np.minimum(np.array(idx, dtype=np.int64), src - 1)


def pad(frame: bytes, pad_w: int, pad_h: int) -> bytes:
    """``pad_w`` spaces before every line that has a byte after its start,
    then ``pad_h`` newlines on top."""
    if pad_w:
        spaces = b" " * pad_w
        lines = frame.split(b"\n")
        last = spaces + lines[-1] if lines[-1] else b""
        frame = b"\n".join([spaces + line for line in lines[:-1]] + [last])
    return b"\n" * pad_h + frame
