"""The conversion pipeline: batched frames -> byte-exact ANSI frames.

Counterpart of ``asciichat_tpu/render/pipeline.py``: geometry on the host
(``oracle.compute_render_geometry``), cell records on the device
(``ops/cells.render_cells``: K2, or K1 for the half-block RGB modes), then the
native emitter (``render/emitter.py`` over ``native/emitter.cpp``) on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asciichat_tpu_torch.ops import cells, ingest
from asciichat_tpu_torch.render import emitter
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.oracle import compute_render_geometry
from asciichat_tpu_torch.render.types import TerminalCapabilities
from asciichat_tpu_torch.runtime.device import default_device
from asciichat_tpu_torch.utils import trace

# Geometries whose gather tables a renderer keeps on its device.
TABLE_CACHE_MAX = 16


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """Static per-(shape, caps) geometry, reused across frames of a stream."""

    mode: str
    dst_w: int
    dst_h_px: int  # pixel rows fed to the renderer (2x cells for half-block)
    pad_w: int
    pad_h: int


def plan_render(
    src_w: int,
    src_h: int,
    width: int,
    height: int,
    caps: TerminalCapabilities,
    use_aspect_ratio: bool = True,
    stretch: bool = False,
) -> RenderPlan:
    rw, rh, pad_w, pad_h = compute_render_geometry(
        src_w, src_h, width, height, caps, use_aspect_ratio, stretch
    )
    return RenderPlan(caps.renderer_key(), rw, rh, pad_w, pad_h)


class AsciiRenderer:
    """Reusable batched renderer for one palette on one device. It keeps the
    palette's ramp, the gather tables of the geometries it has rendered and,
    on a CUDA device, pinned buffers for the record fetch."""

    def __init__(self, palette: str = pal.DEFAULT_PALETTE,
                 device: torch.device | str | None = None):
        self.palette = palette
        self.device = torch.device(device) if device is not None else default_device()
        self._ramp = cells.ramp_for_palette(palette)
        self._tables: dict[tuple, cells.CellTables] = {}
        self._staging = cells.HostStaging() if self.device.type == "cuda" else None

    def _tables_for(self, src_h: int, src_w: int, plan: RenderPlan) -> cells.CellTables:
        key = (src_h, src_w, plan.dst_h_px, plan.dst_w)
        tables = self._tables.get(key)
        if tables is None:
            if len(self._tables) >= TABLE_CACHE_MAX:
                self._tables.pop(next(iter(self._tables)))
            tables = self._tables[key] = cells.cell_tables(
                src_h, src_w, plan.dst_h_px, plan.dst_w, self.device)
            trace.count("table_builds")
        return tables

    @trace.spanned("render.records")
    def cells_for_plan(self, frames: torch.Tensor, plan: RenderPlan,
                       tables: cells.CellTables | None = None) -> cells.RecordDict:
        """Device part only: frames uint8 [B,Hs,Ws,3] -> cell records
        (``tables``: the geometry's gather tables, looked up where not given)."""
        if tables is None and frames.device.type == "cuda":
            tables = self._tables_for(frames.shape[1], frames.shape[2], plan)
        return cells.render_cells(frames, self._ramp, dst_h=plan.dst_h_px,
                                  dst_w=plan.dst_w, mode=plan.mode, tables=tables)

    @trace.spanned("render.ingest")
    def to_device(self, frames: np.ndarray | torch.Tensor,
                  rows: np.ndarray | None = None) -> torch.Tensor:
        """A uint8 tensor of ``frames`` on the renderer's device; with
        ``rows`` (for frames that ``ingest.takes_rows``), of those source
        rows alone, [B, len(rows), W, 3], one 2-D copy a row. Counts the
        ``bytes`` it hands over and the batches that went either way."""
        if rows is not None:
            out = ingest.copy_rows(frames, rows, self.device)
            trace.count("ingest_row_batches")
            trace.count("ingest_rows", len(rows))
            trace.count("bytes", out.nbytes)
            return out
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.uint8))
        trace.count("ingest_whole_batches")
        trace.count("bytes", frames.nbytes)
        return frames.to(self.device, torch.uint8)

    @trace.spanned("render.convert_batch", request=True)
    def convert_batch(
        self,
        frames: np.ndarray | torch.Tensor,
        width: int,
        height: int,
        caps: TerminalCapabilities,
        use_aspect_ratio: bool = True,
        stretch: bool = False,
    ) -> list[bytes]:
        """Full conversion for a batch: [B, Hs, Ws, 3] uint8 -> B ANSI frames.
        Each call is one request of the process's tracer (utils/trace.py), a
        span a stage: plan, ingest, records, fetch, emit. The plan comes from
        the host frames' shape, so that pinned host frames go to the card as
        the source rows the geometry samples alone (ops/ingest.py)."""
        if frames.ndim != 4 or frames.shape[-1] != 3:
            # a single [H,W,3] frame here would read W as the height and 3 as
            # the width, and the native emitter would then walk 3x the bytes
            # the records hold
            raise ValueError(
                f"convert_batch expects [B,H,W,3], got {tuple(frames.shape)}; "
                "use convert() for a single frame")
        src_h, src_w = frames.shape[1], frames.shape[2]
        with trace.span("render.plan"):
            plan = plan_render(src_w, src_h, width, height, caps, use_aspect_ratio, stretch)
            tables = (self._tables_for(src_h, src_w, plan) if self.device.type == "cuda"
                      else None)
        if tables is not None and ingest.takes_rows(frames, self.device, tables.rows):
            frames, tables = self.to_device(frames, tables.rows), tables.compact
        else:
            frames = self.to_device(frames)
        records = self.cells_for_plan(frames.contiguous(), plan, tables)
        host = cells.records_to_numpy(records, self._staging)
        return emitter.emit_frames(
            host, plan.mode, self.palette, pad_w=plan.pad_w, pad_h=plan.pad_h
        )

    def convert(
        self,
        frame: np.ndarray,
        width: int,
        height: int,
        caps: TerminalCapabilities,
        use_aspect_ratio: bool = True,
        stretch: bool = False,
    ) -> bytes:
        """Single-frame convenience (matches ascii_convert_with_capabilities)."""
        return self.convert_batch(
            frame[None], width, height, caps, use_aspect_ratio, stretch
        )[0]
