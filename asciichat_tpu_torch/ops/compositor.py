"""N-client grid compositor: host layout planning and the plain gather.

The planners are copied from ``asciichat_tpu/ops/compositor.py:37-171,197-202``
(that module imports JAX at the top); tests hold each copy equal to its
original. Semantics ground truth (src/server/stream.c):
- grid scoring:     calculate_optimal_grid_layout, stream.c:523-651
- pixel space:      composite is width x (height*2) px (stream.c:673-679)
- CONTAIN fit:      +0.5f rounding, centering (cell-target)/2, cell +
  composite clipping, max 9 sources (stream.c:687-773)
- per-cell resize:  fixed-point 16.16 nearest neighbour (image_resize)

:func:`compose_maps` folds the renderer's resize into the composite maps, and
:func:`pixel_words` turns them into one word per output pixel for a given
source stack, so K3 (``csrc/render_group.cu``) reads each output pixel
straight from the stack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asciichat_tpu_torch.utils.aspect import CHAR_ASPECT, resize_indices

PIXELS_PER_CHAR_HEIGHT = 2
MAX_COMPOSITE_SOURCES = 9  # stream.c:687


def optimal_grid_layout(
    source_sizes: list[tuple[int, int]], term_w: int, term_h: int
) -> tuple[int, int]:
    """(cols, rows) maximizing utilization (stream.c:523-651). Sizes are (w, h)
    of the active video sources; terminal dims are in characters."""
    n = len(source_sizes)
    if n == 0:
        return 0, 0
    if n == 1:
        return 1, 1

    aspects = [np.float32(w) / np.float32(h) for w, h in source_sizes if h > 0]
    avg_aspect = np.float32(sum(aspects) / len(aspects)) if aspects else np.float32(1.6)

    best_cols, best_rows = 1, n
    best_util = np.float32(0.0)
    for cols in range(1, n + 1):
        rows = (n + cols - 1) // cols
        if cols * rows - n > cols:
            continue
        cell_w = term_w // cols
        cell_h = term_h // rows
        if cell_w < 20 or cell_h < 10:
            continue
        cell_area = cell_w * cell_h
        cell_visual_aspect = np.float32(cell_w) / (np.float32(cell_h) * CHAR_ASPECT)
        # scored with the average aspect, as the reference package does
        if avg_aspect > cell_visual_aspect:
            fw = cell_w
            fh = int((cell_w / avg_aspect) / CHAR_ASPECT)
        else:
            fh = cell_h
            fw = int(cell_h * CHAR_ASPECT * avg_aspect)
        fw = min(fw, cell_w)
        fh = min(fh, cell_h)
        util = np.float32(fw * fh) / np.float32(cell_area)
        if util > best_util:
            best_util = util
            best_cols, best_rows = cols, rows
    return best_cols, best_rows


@dataclasses.dataclass(frozen=True, eq=False)
class CompositePlan:
    """Static gather maps for one (layout, source sizes, terminal)
    combination. eq=False: the fields are ndarrays."""

    width_px: int
    height_px: int
    cols: int
    rows: int
    # gather maps int32 [height_px, width_px]; client -1 = background (black)
    client_idx: np.ndarray
    src_y: np.ndarray
    src_x: np.ndarray


def plan_composite(
    source_sizes: list[tuple[int, int]], term_w: int, term_h: int
) -> CompositePlan:
    """Build the composite gather maps (create_multi_source_composite,
    stream.c:664-779) for active sources with pixel sizes (w, h)."""
    comp_w = term_w
    comp_h = term_h * PIXELS_PER_CHAR_HEIGHT
    cols, rows = optimal_grid_layout(source_sizes, term_w, term_h)
    cidx = np.full((comp_h, comp_w), -1, dtype=np.int32)
    sy = np.zeros((comp_h, comp_w), dtype=np.int32)
    sx = np.zeros((comp_h, comp_w), dtype=np.int32)

    for i, (src_w, src_h) in enumerate(source_sizes[:MAX_COMPOSITE_SOURCES]):
        if cols == 0:
            break
        row = i // cols
        col = i % cols
        cell_w = comp_w // cols
        cell_h = comp_h // rows
        if cell_w <= 0 or cell_h <= 0:
            continue  # degenerate layout: no pixel to draw this source into
        if src_w <= 0 or src_h <= 0:
            continue  # degenerate sources compose nothing
        src_aspect = np.float32(src_w) / np.float32(src_h)
        cell_aspect = np.float32(cell_w) / np.float32(cell_h)
        if src_aspect > cell_aspect:
            tw = cell_w
            th = int(np.float32(cell_w) / src_aspect + np.float32(0.5))
        else:
            th = cell_h
            tw = int(np.float32(cell_h) * src_aspect + np.float32(0.5))
        if tw <= 0 or th <= 0:
            continue  # CONTAIN parity (stream.c:711): a 0-px fit draws nothing

        cell_x0 = col * cell_w
        cell_y0 = row * cell_h
        x_pad = (cell_w - tw) // 2
        y_pad = (cell_h - th) // 2

        ry = resize_indices(src_h, th)
        rx = resize_indices(src_w, tw)

        # destination rect with cell + composite clipping (stream.c:752-773)
        for yy in range(th):
            dy = cell_y0 + y_pad + yy
            if dy < cell_y0 or dy > cell_y0 + cell_h - 1 or dy < 0 or dy >= comp_h:
                continue
            xs = np.arange(tw)
            dxs = cell_x0 + x_pad + xs
            ok = (dxs >= cell_x0) & (dxs <= cell_x0 + cell_w - 1) & (dxs >= 0) & (dxs < comp_w)
            cidx[dy, dxs[ok]] = i
            sy[dy, dxs[ok]] = ry[yy]
            sx[dy, dxs[ok]] = rx[xs[ok]]

    return CompositePlan(comp_w, comp_h, cols, rows, cidx, sy, sx)


def host_maps(plan: CompositePlan) -> tuple[np.ndarray, ...]:
    """Host gather maps: (cidx, sy, sx, mask), background cidx clamped to 0."""
    return (np.maximum(plan.client_idx, 0), plan.src_y, plan.src_x,
            (plan.client_idx >= 0)[..., None])


def compose_maps(cidx: np.ndarray, src_y: np.ndarray, src_x: np.ndarray,
                 mask: np.ndarray, dst_h: int, dst_w: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold the renderer's resize of the composite into the gather maps:
    int32 [dst_h, dst_w] (cidx, sy, sx) with cidx -1 for background. Both
    steps are pure selections, so output pixel (y, x) reads source pixel
    M[ry[y], rx[x]] of the composite maps M."""
    ry = resize_indices(cidx.shape[0], dst_h)[:, None]
    rx = resize_indices(cidx.shape[1], dst_w)[None, :]
    keep = mask.reshape(cidx.shape)[ry, rx]
    return (np.where(keep, cidx[ry, rx], -1).astype(np.int32),
            np.ascontiguousarray(src_y[ry, rx], np.int32),
            np.ascontiguousarray(src_x[ry, rx], np.int32))


def pixel_words(k_cidx: np.ndarray, k_sy: np.ndarray, k_sx: np.ndarray,
                stack_shape: tuple[int, ...]) -> np.ndarray:
    """The composed maps of :func:`compose_maps` as one int32 word per
    output pixel for a uint8 [S, H, W, 3] source stack: the byte offset of
    the pixel it reads, or -1 for background. Raises where the stack's
    bytes do not fit an int32 offset."""
    s, h, w = stack_shape[:3]
    if s * h * w * 3 > np.iinfo(np.int32).max:
        raise ValueError(f"source stack {tuple(stack_shape)}: {s * h * w * 3} bytes, "
                         "more than an int32 offset reaches")
    offsets = ((k_cidx.astype(np.int64) * h + k_sy) * w + k_sx) * 3
    return np.where(k_cidx >= 0, offsets, -1).astype(np.int32)


def composite_gather(frames: torch.Tensor, cidx: torch.Tensor, src_y: torch.Tensor,
                     src_x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain gather: frames uint8 [S, H, W, 3] -> composite uint8
    [height_px, width_px, 3] through host_maps-order maps; background is
    black (image_clear)."""
    gathered = frames[cidx.long(), src_y.long(), src_x.long()]
    return torch.where(mask, gathered, torch.zeros_like(gathered))


def composite_reference(frames: np.ndarray, plan: CompositePlan) -> np.ndarray:
    """Host (numpy) reference: the same maps applied with numpy."""
    cidx = np.maximum(plan.client_idx, 0)
    out = frames[cidx, plan.src_y, plan.src_x]
    out[plan.client_idx < 0] = 0
    return out
