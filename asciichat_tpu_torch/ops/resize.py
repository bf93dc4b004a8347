"""K1, the nearest-neighbour resize kernel: the port of
``asciichat_tpu/ops/pallas_resize.py::resize_nn_pallas``.

On a CUDA tensor :func:`resize_nn` launches the hand-written gather
(``csrc/resize.cu``); on a CPU tensor it runs the plain version,
:func:`asciichat_tpu_torch.ops.pixel.resize_nn`. The row and column tables are
``utils/aspect.resize_indices`` of the shapes, built on the host; callers on
a hot path build them once per shape with :func:`resize_tables` and pass them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asciichat_tpu_torch.ops import pixel
from asciichat_tpu_torch.runtime.device import check_tensor, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel
from asciichat_tpu_torch.utils.aspect import resize_indices

RESIZE_KERNEL = Kernel(
    "resize_nn", "ac_resize_nn", "asciichat_tpu_torch/csrc/resize.cu",
    "asciichat_tpu/ops/pallas_resize.py:95")


@dataclasses.dataclass(frozen=True, eq=False)
class IndexTables:
    """Row and column gather tables on a device, built on the host for a
    source of ``src_h`` x ``src_w`` pixels: every index lies inside it."""

    src_h: int
    src_w: int
    sy: torch.Tensor  # int32 [rows]
    sx: torch.Tensor  # int32 [cols]

    @classmethod
    def from_host(cls, src_h: int, src_w: int, sy: np.ndarray, sx: np.ndarray,
                  device: torch.device) -> IndexTables:
        if sy.size and not 0 <= sy.min() <= sy.max() < src_h:
            raise ValueError(f"row index outside 0..{src_h - 1}")
        if sx.size and not 0 <= sx.min() <= sx.max() < src_w:
            raise ValueError(f"column index outside 0..{src_w - 1}")
        return cls(src_h, src_w,
                   torch.from_numpy(np.ascontiguousarray(sy, np.int32)).to(device),
                   torch.from_numpy(np.ascontiguousarray(sx, np.int32)).to(device))


def resize_tables(src_h: int, src_w: int, dst_h: int, dst_w: int,
                  device: torch.device) -> IndexTables:
    return IndexTables.from_host(src_h, src_w, resize_indices(src_h, dst_h),
                                 resize_indices(src_w, dst_w), device)


def gather(frames: torch.Tensor, tables: IndexTables) -> torch.Tensor:
    """K1 launch: out[b, y, x] = frames[b, sy[y], sx[x]] for a uint8
    [B, H, W, 3] batch on a CUDA device."""
    dev = frames.device
    check_tensor(frames, "frames", torch.uint8, (None, tables.src_h, tables.src_w, 3), dev)
    check_tensor(tables.sy, "sy", torch.int32, (None,), dev)
    check_tensor(tables.sx, "sx", torch.int32, (None,), dev)
    b, h, w, _ = frames.shape
    dh, dw = tables.sy.shape[0], tables.sx.shape[0]
    out = torch.empty((b, dh, dw, 3), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        RESIZE_KERNEL(frames.data_ptr(), b, h, w, tables.sy.data_ptr(), dh,
                      tables.sx.data_ptr(), dw, out.data_ptr(), stream_handle(dev))
    return out


def resize_nn(frames: torch.Tensor, dst_h: int, dst_w: int,
              tables: IndexTables | None = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [B, dst_h, dst_w, 3], bit-exact 16.16 NN resize."""
    if frames.device.type == "cpu":
        return pixel.resize_nn(frames, dst_h, dst_w)
    if tables is None:
        tables = resize_tables(frames.shape[1], frames.shape[2], dst_h, dst_w,
                               frames.device)
    if (tables.sy.shape[0], tables.sx.shape[0]) != (dst_h, dst_w):
        raise ValueError(f"tables are for {tables.sy.shape[0]}x{tables.sx.shape[0]}, "
                         f"not {dst_h}x{dst_w}")
    return gather(frames, tables)
