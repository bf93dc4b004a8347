"""ASCII-space grid compositor: combine rendered ASCII frames with | _ +
separators.

Byte-exact re-derivation of ascii_create_grid (lib/video/ascii/ascii.c:602-880)
and its ANSI-aware width helpers (ascii.c:527-585), used by the reference's
P2P session host to mix participants in ASCII space
(src/common/session/host.c:710). The production server composites in PIXEL
space before one batched render (ops/compositor.py — better quality and one
kernel); this ASCII-space variant is the counterpart for sources that are
already ANSI frames.

Semantics preserved exactly:
- visual width counts BYTES outside CSI sequences (a UTF-8 glyph counts once
  per byte — the reference's own quirk, ascii.c:544-546);
- grid scoring in float32 (logf/fabsf), 2-source layouts weight aspect 0.9,
  square grids get +0.05, >50%-empty and <10x3-cell layouts are skipped;
- cells too small -> first source returned unchanged;
- '|' vertical separators per cell column, '_' horizontal, '+' corners.
"""

from __future__ import annotations

import math

import numpy as np

ESC = 0x1B
MIN_CELL_W, MIN_CELL_H = 10, 3  # ascii.c:733-734
CHAR_ASPECT = 2.0  # terminal cells ~2x taller than wide (ascii.c:715)


def ansi_visual_width(data: bytes, length: int | None = None) -> int:
    """Visible columns, skipping CSI sequences (ascii.c:527-551)."""
    n = len(data) if length is None else length
    width = 0
    i = 0
    while i < n:
        if data[i] == ESC and i + 1 < n and data[i + 1] == ord("["):
            i += 2
            while i < n:
                c = data[i]
                i += 1
                if 0x40 <= c <= 0x7E:
                    break
        else:
            width += 1
            i += 1
    return width


def ansi_truncate_to_visual_width(data: bytes, length: int, target: int) -> int:
    """Byte position truncating to `target` visible columns while keeping
    complete CSI sequences (ascii.c:562-585)."""
    width = 0
    i = 0
    while i < length and width < target:
        if data[i] == ESC and i + 1 < length and data[i + 1] == ord("["):
            i += 2
            while i < length:
                c = data[i]
                i += 1
                if 0x40 <= c <= 0x7E:
                    break
        else:
            width += 1
            i += 1
    return i


def _blank_canvas(width: int, height: int) -> bytearray:
    """width x height spaces with a '\\n' terminating every row
    (ascii.c:633-640)."""
    buf = bytearray(b" " * ((width + 1) * height))
    for row in range(height):
        buf[row * (width + 1) + width] = ord("\n")
    return buf


def _grid_shape(source_count: int, width: int, height: int) -> tuple[int, int]:
    """Score every cols x rows layout in float32 exactly like
    ascii.c:714-772."""
    f32 = np.float32
    best_score = f32(-1.0)
    best_cols, best_rows = 1, source_count
    for cols in range(1, source_count + 1):
        rows = math.ceil(source_count / cols)
        empty = cols * rows - source_count
        if empty > source_count // 2:
            continue  # >50% wasted cells
        cell_w = (width - (cols - 1)) // cols
        cell_h = (height - (rows - 1)) // rows
        if cell_w < MIN_CELL_W or cell_h < MIN_CELL_H:
            continue
        cell_aspect = f32(f32(cell_w) / f32(cell_h)) / f32(CHAR_ASPECT)
        aspect_score = f32(1.0) - f32(abs(np.log(cell_aspect, dtype=f32)))
        if aspect_score < 0:
            aspect_score = f32(0.0)
        utilization = f32(source_count) / f32(cols * rows)
        if source_count == 2:
            total = f32(aspect_score * f32(0.9) + utilization * f32(0.1))
        else:
            total = f32(aspect_score * f32(0.7) + utilization * f32(0.3))
        if cols == rows:
            total = f32(total + f32(0.05))
        if total > best_score:
            best_score = total
            best_cols, best_rows = cols, rows
    return best_cols, best_rows


def create_grid(sources: list[bytes], width: int, height: int) -> bytes:
    """ascii_create_grid (ascii.c:602-880): N ANSI frames -> one width x
    height frame with '|'/'_'/'+' separators (or centered, for one source)."""
    if not sources or width <= 0 or height <= 0:
        raise ValueError("create_grid needs sources and positive dimensions")

    if len(sources) == 1:
        buf = _blank_canvas(width, height)
        src = sources[0]
        if not src:
            return bytes(buf)
        target_size = len(buf) + 1  # the C buffer includes a NUL (ascii.c:631)
        src_lines = src.count(b"\n")
        v_pad = max(0, (height - src_lines) // 2)
        dst_row = v_pad
        pos = 0
        n = len(src)
        while pos < n and dst_row < height:
            line_start = pos
            while pos < n and src[pos] != ord("\n"):
                pos += 1
            line = src[line_start:pos]
            h_pad = max(0, (width - ansi_visual_width(line)) // 2)
            copy_len = ansi_truncate_to_visual_width(line, len(line), width - h_pad)
            dst_pos = dst_row * (width + 1) + h_pad
            if copy_len > 0 and dst_pos + copy_len < target_size:
                end = min(dst_pos + copy_len, len(buf))
                buf[dst_pos:end] = line[: end - dst_pos]
            if pos < n and src[pos] == ord("\n"):
                pos += 1
            dst_row += 1
        return bytes(buf)

    cols, rows = _grid_shape(len(sources), width, height)
    cell_w = (width - (cols - 1)) // cols
    cell_h = (height - (rows - 1)) // rows
    if cell_w < MIN_CELL_W or cell_h < MIN_CELL_H:
        return bytes(sources[0])  # too small for a grid (ascii.c:779-792)

    buf = _blank_canvas(width, height)
    mixed_size = len(buf) + 1  # C size includes the NUL
    for idx, src in enumerate(sources):
        grid_row, grid_col = divmod(idx, cols)
        start_row = grid_row * (cell_h + 1)
        start_col = grid_col * (cell_w + 1)

        pos = 0
        src_row = 0
        n = len(src)
        while pos < n and src_row < cell_h and start_row + src_row < height:
            line_start = pos
            while pos < n and src[pos] != ord("\n"):
                pos += 1
            line = src[line_start:pos]
            copy_len = ansi_truncate_to_visual_width(line, len(line), cell_w)
            vis = ansi_visual_width(line, copy_len)
            if copy_len > 0 and start_col + vis <= width:
                at = (start_row + src_row) * (width + 1) + start_col
                # SAFE_MEMCPY is all-or-nothing (platform_memcpy rejects
                # count > dest_size and copies NOTHING, common.h:468 +
                # ascii.c:845): clamping to a partial write emitted a
                # truncated CSI fragment and overwrote the final row's
                # '\n'. (at+copy_len == mixed_size would land on the C NUL
                # and make the closing strlen read OOB — C UB we refuse to
                # reproduce, so that edge also drops.)
                if at + copy_len < mixed_size:
                    buf[at:at + copy_len] = line[:copy_len]
            if pos < n and src[pos] == ord("\n"):
                pos += 1
            src_row += 1

        # separators (ascii.c:854-880)
        if grid_col < cols - 1 and start_col + cell_w < width:
            for row in range(start_row, min(start_row + cell_h, height)):
                at = row * (width + 1) + start_col + cell_w
                if at < mixed_size - 1:
                    buf[at] = ord("|")
        if grid_row < rows - 1 and start_row + cell_h < height:
            for col in range(start_col, min(start_col + cell_w, width)):
                at = (start_row + cell_h) * (width + 1) + col
                if at < mixed_size - 1:
                    buf[at] = ord("_")
            if grid_col < cols - 1 and start_col + cell_w < width:
                at = (start_row + cell_h) * (width + 1) + start_col + cell_w
                if at < mixed_size - 1:
                    buf[at] = ord("+")
    return bytes(buf)
