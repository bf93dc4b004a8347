"""Ingest of only the source rows the renderer samples.

K1 and K2 (``ops/resize.py``, ``ops/cells.py``) are nearest-neighbour
gathers: they read the rows ``utils/aspect.resize_indices`` samples and no
other. At 1080p -> 57 pixel rows a batch of 128 frames needs 42.0 MB of its
796 MB on the card (84.0 MB at 114 rows). :func:`copy_rows` moves just those
rows into a compact batch [B, R, W, 3], one copy-engine 2-D copy a sampled
row across the batch (``csrc/ingest.cu``); the kernels then gather from it
through tables whose row indices point into it (``cells.CellTables.compact``).

:func:`takes_rows` is the rule the renderer follows: the row copy reads the
caller's host memory directly, so it takes pinned frames whose rows it can
address, and only where the geometry samples at most half the rows (an
upscale or a near-1:1 geometry would copy most of the frame anyway). Every
other input goes to the card whole.
"""

from __future__ import annotations

import numpy as np
import torch

from asciichat_tpu_torch.runtime.device import stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel

ROW_COPY = Kernel("copy_rows", "ac_copy_rows", "asciichat_tpu_torch/csrc/ingest.cu",
                  "asciichat_tpu/render/pipeline.py:75")

# The copy engine's largest pitch (cudaDeviceProp.memPitch on Hopper).
MAX_PITCH = 2**31 - 1


def row_layout(frames) -> tuple[int, int] | None:
    """(frame stride, row stride) in bytes of a non-empty uint8 [B, H, W, 3]
    CPU tensor whose rows' W * 3 bytes are contiguous and whose frames lie a
    whole number of rows apart, else None."""
    if not (isinstance(frames, torch.Tensor) and frames.device.type == "cpu"
            and frames.dtype == torch.uint8 and frames.ndim == 4 and frames.shape[3] == 3
            and frames.numel()):
        return None
    b, h, w, _ = frames.shape
    line = w * 3
    # a dimension of extent 1 has no stride to speak of: give it the packed one
    s0, s1, s2, s3 = frames.stride()
    s1 = s1 if h > 1 else line
    s0 = s0 if b > 1 else h * s1
    if (s3 != 1 or (w > 1 and s2 != 3) or s1 < line or s0 < h * s1 or s0 % s1
            or s0 > MAX_PITCH):
        return None
    return s0, s1


def takes_rows(frames, device: torch.device, rows: np.ndarray | None) -> bool:
    """Whether ``frames`` go to ``device`` as the sampled ``rows`` alone
    (``rows``: ``cells.CellTables.rows``, None where the geometry samples
    more than half the source's rows): pinned host frames bound for a card."""
    return (rows is not None and device.type == "cuda" and row_layout(frames) is not None
            and frames.is_pinned())


def copy_rows(frames: torch.Tensor, rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """frames[:, rows] as a uint8 [B, len(rows), W, 3] tensor on ``device``.
    On a card the frames must pass :func:`takes_rows`; the copies are queued
    on the current stream, so the frames stay untouched until it has passed
    them. On the CPU, the plain version."""
    if device.type == "cpu":
        return frames[:, torch.from_numpy(np.asarray(rows, np.int64))].contiguous()
    layout = row_layout(frames)
    if layout is None or not frames.is_pinned():
        raise ValueError("copy_rows takes pinned uint8 [B,H,W,3] host frames whose rows are "
                         "contiguous and whose frames lie a whole number of rows apart")
    h = frames.shape[1]
    if rows.size and not 0 <= rows.min() <= rows.max() < h:
        raise ValueError(f"row index outside 0..{h - 1}")
    b, _, w, _ = frames.shape
    host_rows = np.ascontiguousarray(rows, np.int32)
    out = torch.empty((b, len(host_rows), w, 3), dtype=torch.uint8, device=device)
    if out.numel():
        with torch.cuda.device(device):
            ROW_COPY(frames.data_ptr(), b, *layout, w * 3, host_rows.ctypes.data,
                     len(host_rows), out.data_ptr(), stream_handle(device))
    return out
