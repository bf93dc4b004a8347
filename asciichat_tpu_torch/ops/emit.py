"""Truecolor-FG ANSI bytes made on the device, off every serving path.

Counterpart of ``asciichat_tpu/ops/emit.py``, the JAX package's measured
experiment in device emission. On a CUDA tensor :func:`emit_truecolor_fg`
launches K6 (``csrc/emit.cu``: one CTA per frame, a block scan of the cells'
byte lengths and a scatter of each cell's bytes to its offset); on a CPU
tensor it runs the plain version, :func:`emit_truecolor_fg_reference`. The
mirror, the server and ``bench`` emit on the host (``render/emitter.py``);
``chip_smoke.py`` times K6 against that path.

The grammar is render/oracle.render_truecolor_fg (the reference's
image_print_color, scalar/foreground.c:195-308 + ansi.c:248-311) as a
parallel program:

1. a cell emits ``ESC[38;2;R;G;Bm`` iff its colour differs from the previous
   cell's in raster order (the state crosses row ends; the first cell
   always emits);
2. a cell's byte length is 10 + the digits of R, G and B for the SGR, + 1
   glyph byte, + 1 for the '\\n' that ends every row but the last; the
   lengths' exclusive prefix sum gives each cell's offset;
3. each cell's <= 21 bytes are written at its offset, digits without
   leading zeros;
4. one ``ESC[0m`` ends the frame.

ASCII palettes only (:func:`ascii_glyph_table` refuses multi-byte glyphs,
which bypass the colour state in the reference); the output is a fixed
worst-case buffer per frame, 0 past the frame's length, and the lengths.
"""

from __future__ import annotations

import numpy as np
import torch

from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.runtime.device import check_tensor, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel

CMAX = 21  # worst per-cell bytes: ESC[38;2;RRR;GGG;BBBm (19) + glyph + \n
_PREFIX = np.frombuffer(b"\x1b[38;2;", dtype=np.uint8).astype(np.int32)
_RESET = np.array(list(b"\x1b[0m"), dtype=np.uint8)

EMIT_KERNEL = Kernel(
    "device_emit", "ac_device_emit", "asciichat_tpu_torch/csrc/emit.cu",
    "asciichat_tpu/ops/emit.py:152")


def worst_bytes(h: int, w: int) -> int:
    """A frame's buffer: every cell at its longest but for one '\\n' slot
    a row (20 bytes), and the reset."""
    return h * w * (CMAX - 1) + len(_RESET)


def ascii_glyph_table(palette: str = pal.DEFAULT_PALETTE) -> np.ndarray:
    """uint8[256] single-byte glyph per clamped luminance, or ValueError for
    palettes with multi-byte glyphs (those use the host emitter)."""
    tbl = pal.luminance_glyph_table(palette)
    if not (tbl[:, 0] == 1).all() or not (tbl[:, 1] < 128).all():
        raise ValueError(f"palette {palette!r} has multi-byte glyphs; "
                         "device emission supports ASCII palettes only")
    return tbl[:, 1].copy()


def _check_shape(h: int, w: int) -> None:
    if h <= 0 or w <= 0:
        raise ValueError(f"frames of {h}x{w} cells: device emission needs at least one cell")
    if worst_bytes(h, w) >= 2**31:
        raise ValueError(f"frames of {h}x{w} cells: lengths would pass int32")


def emit_truecolor_fg_reference(rgb: torch.Tensor, luma: torch.Tensor,
                                glyph_tbl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`emit_truecolor_fg` on the records' device:
    rgb u8 [B,H,W,3], luma u8 [B,H,W], glyph_tbl u8 [256] -> (bytes u8
    [B, H*W*20+4], lengths i32 [B]), the four steps of the module
    docstring with the compaction as one scatter."""
    b, h, w, _ = rgb.shape
    _check_shape(h, w)
    dev = rgb.device
    n = h * w
    px = rgb.reshape(b, n, 3).to(torch.int32)
    glyph = glyph_tbl.to(dev, torch.int32)[luma.reshape(b, n).long()]
    idx = torch.arange(n, device=dev)

    # 1. SGR decision against the raster predecessor; the first cell always
    sgr = (px != px.roll(1, dims=1)).any(-1)
    sgr[:, 0] = True

    # 2. lengths and their exclusive prefix sum
    dig = 1 + (px >= 10).to(torch.int32) + (px >= 100).to(torch.int32)  # [b, n, 3]
    sgr_len = torch.where(sgr, 10 + dig.sum(-1), 0)
    nl = ((idx + 1) % w == 0) & (idx != n - 1)
    cell_len = sgr_len + 1 + nl.to(torch.int32)
    ends = cell_len.cumsum(1)
    offs = ends - cell_len
    lengths = (ends[:, -1] + len(_RESET)).to(torch.int32)

    # 3. each cell's bytes, positionally [b, n, CMAX]; emitted digit k (most
    # significant first) of a d-digit value is place k + 3 - d of
    # [hundreds, tens, ones]
    j = torch.arange(CMAX, device=dev)
    places = torch.stack([px // 100, (px // 10) % 10, px % 10], dim=-1)  # [b, n, 3, 3]
    dr, dg, db = (dig[..., c, None] for c in range(3))

    def digit_at(comp: int, start: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        place = (j - start + 3 - d).clamp(0, 2)
        return 48 + places[:, :, comp, :].gather(-1, place)

    s = sgr[..., None]
    out = torch.zeros((b, n, CMAX), dtype=torch.int32, device=dev)
    prefix = torch.from_numpy(_PREFIX).to(dev)[j.clamp(max=6)]
    out = torch.where(s & (j < 7), prefix, out)
    out = torch.where(s & (j >= 7) & (j < 7 + dr), digit_at(0, 7, dr), out)
    out = torch.where(s & (j == 7 + dr), 59, out)  # ';'
    out = torch.where(s & (j >= 8 + dr) & (j < 8 + dr + dg), digit_at(1, 8 + dr, dg), out)
    out = torch.where(s & (j == 8 + dr + dg), 59, out)
    start_b = 9 + dr + dg
    out = torch.where(s & (j >= start_b) & (j < start_b + db), digit_at(2, start_b, db), out)
    out = torch.where(s & (j == start_b + db), 109, out)  # 'm'
    out = torch.where(j == sgr_len[..., None], glyph[..., None], out)
    out = torch.where((j == sgr_len[..., None] + 1) & nl[:, None], 10, out)

    # 4. compaction: each chunk's bytes scattered at its offset, then the reset
    worst = worst_bytes(h, w)
    data = torch.zeros((b, worst), dtype=torch.uint8, device=dev)
    keep = j < cell_len[..., None]
    flat = torch.arange(b, device=dev)[:, None, None] * worst + offs[..., None] + j
    data.view(-1)[flat[keep]] = out[keep].to(torch.uint8)
    at = (lengths - len(_RESET)).long()[:, None] + torch.arange(len(_RESET), device=dev)
    data.scatter_(1, at, torch.from_numpy(_RESET).to(dev).expand(b, -1).contiguous())
    return data, lengths


def emit_truecolor_fg(rgb: torch.Tensor, luma: torch.Tensor,
                      glyph_tbl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rgb u8 [B,H,W,3], luma u8 [B,H,W], glyph_tbl u8 [256] -> (bytes u8
    [B, H*W*20+4], lengths i32 [B]); bytes[i, :lengths[i]] is the frame of
    render/oracle.render_truecolor_fg, the rest 0. K6 on a CUDA device (the
    glyph table is a host tensor that rides by value in the launch), the
    plain version on the CPU."""
    if rgb.device.type == "cpu":
        return emit_truecolor_fg_reference(rgb, luma, glyph_tbl)
    if rgb.device.type != "cuda":
        raise ValueError(f"rgb: on {rgb.device}, expected a CUDA device or the CPU")
    dev = rgb.device
    check_tensor(rgb, "rgb", torch.uint8, (None, None, None, 3), dev)
    b, h, w, _ = rgb.shape
    check_tensor(luma, "luma", torch.uint8, (b, h, w), dev)
    check_tensor(glyph_tbl, "glyph_tbl", torch.uint8, (256,), torch.device("cpu"))
    _check_shape(h, w)
    worst = worst_bytes(h, w)
    data = torch.empty((b, worst), dtype=torch.uint8, device=dev)
    lengths = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        with torch.cuda.device(dev):
            EMIT_KERNEL(rgb.data_ptr(), luma.data_ptr(), glyph_tbl.data_ptr(), b, h, w,
                        data.data_ptr(), worst, lengths.data_ptr(), stream_handle(dev))
    return data, lengths


def emit_frames_device(records: dict, palette: str = pal.DEFAULT_PALETTE) -> list[bytes]:
    """truecolor_fg records (numpy arrays or tensors on any device) -> one
    bytes object per frame through :func:`emit_truecolor_fg`."""
    rgb, luma = torch.as_tensor(records["rgb"]), torch.as_tensor(records["luma"])
    tbl = torch.from_numpy(ascii_glyph_table(palette))
    data, lengths = emit_truecolor_fg(rgb.contiguous(), luma.contiguous(), tbl)
    data_np, lens_np = data.cpu().numpy(), lengths.cpu().numpy()
    return [data_np[i, : lens_np[i]].tobytes() for i in range(luma.shape[0])]
