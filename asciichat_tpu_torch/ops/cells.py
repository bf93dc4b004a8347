"""Batched frames -> cell records, the device half of the render path.

Counterpart of ``asciichat_tpu/ops/cells.py``. On a CUDA tensor
:func:`render_cells` launches K2 (``csrc/cell_records.cu``: the resize gather
with the per-mode record epilogue fused in), or K1 for the two half-block RGB
modes, whose records are the resized rows themselves. On a CPU tensor it runs
the plain version, :func:`records_for_mode` after ``pixel.resize_nn``.

Record schemas per mode (identical keys, dtypes and shapes to the reference,
asciichat_tpu/ops/cells.py:12-21):
  mono:                key u8 [B,H,W]
  truecolor_fg:        rgb u8 [B,H,W,3], luma u8
  256color:            color u8, luma u8
  16color:             color u8, key u8
  16color_dithered*:   rgb u8 [B,H,W,3], luma u8
  halfblock_truecolor: top u8 [B,R,W,3], bot u8
  halfblock_256/16:    fg u8 [B,R,W], bg u8, transparent u8
  halfblock_mono:      top u8 [B,R,W,3], bot u8
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asciichat_tpu_torch.ops import pixel, resize
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.runtime.device import check_tensor, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel
from asciichat_tpu_torch.utils import trace
from asciichat_tpu_torch.utils.aspect import resize_indices

RecordDict = dict[str, torch.Tensor]

MODES = (
    "mono",
    "truecolor_fg",
    "256color",
    "16color",
    "16color_dithered",
    "16color_dithered_bg",
    "halfblock_truecolor",
    "halfblock_256",
    "halfblock_16",
    "halfblock_mono",
)

# Record family of each mode: the `Family` enum of csrc/cells_math.cuh.
FAM_MONO, FAM_RGB_LUMA, FAM_Q256_LUMA, FAM_Q16_KEY, FAM_HB_RGB, FAM_HB_Q256, FAM_HB_Q16 = range(7)
MODE_FAMILY = {
    "mono": FAM_MONO,
    "truecolor_fg": FAM_RGB_LUMA,
    "16color_dithered": FAM_RGB_LUMA,
    "16color_dithered_bg": FAM_RGB_LUMA,
    "256color": FAM_Q256_LUMA,
    "16color": FAM_Q16_KEY,
    "halfblock_truecolor": FAM_HB_RGB,
    "halfblock_mono": FAM_HB_RGB,
    "halfblock_256": FAM_HB_Q256,
    "halfblock_16": FAM_HB_Q16,
}
HALFBLOCK_FAMILIES = frozenset({FAM_HB_RGB, FAM_HB_Q256, FAM_HB_Q16})
# Output records of each family, in the kernels' (o0, o1, o2) order, with
# their dims beyond [B, rows, W].
FAMILY_RECORDS: dict[int, tuple[tuple[str, tuple[int, ...]], ...]] = {
    FAM_MONO: (("key", ()),),
    FAM_RGB_LUMA: (("rgb", (3,)), ("luma", ())),
    FAM_Q256_LUMA: (("color", ()), ("luma", ())),
    FAM_Q16_KEY: (("color", ()), ("key", ())),
    FAM_HB_RGB: (("top", (3,)), ("bot", (3,))),
    FAM_HB_Q256: (("fg", ()), ("bg", ()), ("transparent", ())),
    FAM_HB_Q16: (("fg", ()), ("bg", ()), ("transparent", ())),
}

CELL_RECORDS_KERNEL = Kernel(
    "cell_records", "ac_cell_records", "asciichat_tpu_torch/csrc/cell_records.cu",
    "asciichat_tpu/ops/cells.py:86")


def mode_family(mode: str) -> int:
    try:
        return MODE_FAMILY[mode]
    except KeyError:
        raise ValueError(f"unknown mode {mode!r}") from None


def records_for_mode(resized: torch.Tensor, mode: str, ramp: torch.Tensor) -> RecordDict:
    """Plain version: resized uint8 [B, Hpx, W, 3] (already at renderer
    pixel dims) -> the mode's records (asciichat_tpu/ops/cells.py:51-82)."""
    if mode == "mono":
        return {"key": pixel.mono_keys(resized, ramp)}
    if mode in ("truecolor_fg", "16color_dithered", "16color_dithered_bg"):
        # Floyd-Steinberg error diffusion is raster-sequential (ansi.c:511-583):
        # the dithered modes ship resized RGB + luma and the host emitter dithers
        return {"rgb": resized, "luma": pixel.luminance(resized).to(torch.uint8)}
    if mode == "256color":
        return {"color": pixel.quantize_256(resized),
                "luma": pixel.luminance(resized).to(torch.uint8)}
    if mode == "16color":
        return {"color": pixel.quantize_16(resized), "key": pixel.mono_keys(resized, ramp)}
    if mode in ("halfblock_truecolor", "halfblock_mono"):
        top, bot = pixel.halfblock_split(resized)
        return {"top": top, "bot": bot}
    if mode in ("halfblock_256", "halfblock_16"):
        top, bot = pixel.halfblock_split(resized)
        quant = pixel.quantize_256 if mode == "halfblock_256" else pixel.quantize_16
        transparent = ((top == 0).all(-1) & (bot == 0).all(-1)).to(torch.uint8)
        return {"fg": quant(top), "bg": quant(bot), "transparent": transparent}
    raise ValueError(f"unknown mode {mode!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class CellTables:
    """Gather tables for one (source shape, renderer geometry), built on the
    host once and reused for every batch of that shape."""

    resize: resize.IndexTables  # K2: sy [dst_h_px], sx [dst_w]
    top: resize.IndexTables  # K1, half-block: pixel rows 0, 2, 4, ...
    bot: resize.IndexTables  # K1, half-block: rows 1, 3, ...; odd heights repeat the last


def cell_tables(src_h: int, src_w: int, dst_h: int, dst_w: int,
                device: torch.device) -> CellTables:
    sy = resize_indices(src_h, dst_h)
    sx = resize_indices(src_w, dst_w)
    bot_rows = np.minimum(2 * np.arange((dst_h + 1) // 2) + 1, dst_h - 1)
    return CellTables(
        resize.IndexTables.from_host(src_h, src_w, sy, sx, device),
        resize.IndexTables.from_host(src_h, src_w, sy[0::2], sx, device),
        resize.IndexTables.from_host(src_h, src_w, sy[bot_rows], sx, device),
    )


def allocate_records(family: int, batch: int, hpx: int, width: int,
                     device: torch.device) -> RecordDict:
    """Empty record tensors for ``family`` at ``hpx`` pixel rows."""
    rows = (hpx + 1) // 2 if family in HALFBLOCK_FAMILIES else hpx
    return {name: torch.empty((batch, rows, width, *trailing), dtype=torch.uint8, device=device)
            for name, trailing in FAMILY_RECORDS[family]}


def record_pointers(records: RecordDict) -> list[int]:
    """The records' data pointers as the kernels' (o0, o1, o2), 0 for unused."""
    ptrs = [t.data_ptr() for t in records.values()]
    return ptrs + [0] * (3 - len(ptrs))


def check_ramp(ramp: torch.Tensor) -> None:
    """The ramp is a host table: it rides by value in the kernels' parameters."""
    check_tensor(ramp, "ramp", torch.uint8, (64,), torch.device("cpu"))


def render_cells(frames: torch.Tensor, ramp: torch.Tensor, *, dst_h: int, dst_w: int,
                 mode: str, tables: CellTables | None = None) -> RecordDict:
    """Batched frames uint8 [B, Hs, Ws, 3] -> cell records at (dst_h px,
    dst_w). dst_h is in pixel rows, already doubled for half-block modes
    (ascii.c:229-232). ``ramp`` is the palette's uint8[64] CPU tensor."""
    family = mode_family(mode)
    if frames.device.type == "cpu":
        return records_for_mode(pixel.resize_nn(frames, dst_h, dst_w), mode, ramp)
    if tables is None:
        tables = cell_tables(frames.shape[1], frames.shape[2], dst_h, dst_w, frames.device)
    if (tables.resize.sy.shape[0], tables.resize.sx.shape[0]) != (dst_h, dst_w):
        raise ValueError(f"tables are for {tables.resize.sy.shape[0]}x"
                         f"{tables.resize.sx.shape[0]}, not {dst_h}x{dst_w}")
    if family == FAM_HB_RGB:
        return {"top": resize.gather(frames, tables.top),
                "bot": resize.gather(frames, tables.bot)}
    dev = frames.device
    check_tensor(frames, "frames", torch.uint8,
                 (None, tables.resize.src_h, tables.resize.src_w, 3), dev)
    check_ramp(ramp)
    b, h, w, _ = frames.shape
    records = allocate_records(family, b, dst_h, dst_w, dev)
    if b and dst_h and dst_w:
        with torch.cuda.device(dev):
            CELL_RECORDS_KERNEL(family, frames.data_ptr(), b, h, w,
                                tables.resize.sy.data_ptr(), dst_h,
                                tables.resize.sx.data_ptr(), dst_w, ramp.data_ptr(),
                                *record_pointers(records), stream_handle(dev))
    return records


def ramp_for_palette(palette: str) -> torch.Tensor:
    """The palette's luma->key ramp, uint8[64] on the host."""
    return torch.from_numpy(pal.char_index_ramp_array(palette).copy())


class HostStaging:
    """Pinned host buffers reused across record fetches, one per record name.

    The arrays :func:`records_to_numpy` returns through a staging object are
    views of these buffers: consume them before the next fetch."""

    def __init__(self):
        self._bufs: dict[str, torch.Tensor] = {}

    def buffer(self, name: str, like: torch.Tensor) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = self._bufs[name] = torch.empty(like.shape, dtype=like.dtype,
                                                 pin_memory=True)
            trace.count("staging_allocs")
        return buf


@trace.spanned("render.fetch")
def records_to_numpy(records: RecordDict, staging: HostStaging | None = None
                     ) -> dict[str, np.ndarray]:
    """Device -> host copy of the record dict into C-contiguous arrays (the
    emitter re-copies strided input on every call). CUDA records land in
    pinned buffers, from ``staging`` when given, in one synchronised fetch."""
    cuda = [v.device for v in records.values() if v.device.type == "cuda"]
    if not cuda:
        return {k: np.ascontiguousarray(v.numpy()) for k, v in records.items()}
    staging = staging if staging is not None else HostStaging()
    host = {}
    for k, v in records.items():
        host[k] = staging.buffer(k, v)
        host[k].copy_(v, non_blocking=True)
    with trace.span("render.fetch.sync"):
        torch.cuda.current_stream(cuda[0]).synchronize()
    return {k: v.numpy() for k, v in host.items()}
