"""Per-pixel render ops in plain PyTorch: resize, luma, quantizers, glyph keys.

Counterpart of ``asciichat_tpu/ops/pixel.py``. These are the plain
versions of the kernels' math (``csrc/cells_math.cuh``): the CPU path runs
them, and the tests and ``chip_smoke.py`` hold the kernels against them.
Every op widens uint8 to int32 before arithmetic, as the reference does:
torch's uint8 arithmetic wraps.

The reference's MXU one-hot resize and its ``lax.platform_dependent``
dispatch (pixel.py:63-92) are TPU workarounds for a slow gather and are not
ported: the gather form is the resize.
"""

from __future__ import annotations

import numpy as np
import torch

from asciichat_tpu_torch.utils.aspect import resize_indices

# 16-color ANSI palette (lib/video/terminal/ansi.c:442-459)
ANSI16_RGB = np.array(
    [
        (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
        (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
        (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
        (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
    ],
    dtype=np.int32,
)


def resize_nn(frames: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """Fixed-point 16.16 nearest-neighbour resize (image.c:267-328) of
    uint8 [..., H, W, C]; the index tables come from the host."""
    src_h, src_w = frames.shape[-3], frames.shape[-2]
    if (src_h, src_w) == (dst_h, dst_w):
        return frames
    sy = torch.from_numpy(resize_indices(src_h, dst_h)).to(frames.device, torch.long)
    sx = torch.from_numpy(resize_indices(src_w, dst_w)).to(frames.device, torch.long)
    return frames.index_select(-3, sy).index_select(-2, sx)


def luminance(frames: torch.Tensor) -> torch.Tensor:
    """BT.601 integer luma with rounding, (77R+150G+29B+128)>>8 clamped to
    0..255 (scalar/foreground.c:93-96). int32 [..., H, W]."""
    px = frames.to(torch.int32)
    y = (77 * px[..., 0] + 150 * px[..., 1] + 29 * px[..., 2] + 128) >> 8
    return y.clamp(0, 255)


def mono_keys(frames: torch.Tensor, ramp: torch.Tensor) -> torch.Tensor:
    """Mono run key ramp[luma >> 2] (foreground.c:97-98). uint8."""
    table = ramp.to(frames.device, torch.uint8)
    return table[(luminance(frames) >> 2).long()]


def quantize_256(frames: torch.Tensor) -> torch.Tensor:
    """6x6x6 cube + grayscale ramp (ansi.c:360-379). uint8 [..., H, W]."""
    px = frames.to(torch.int32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    avg = (r + g + b) // 3
    gray_diff = (r - avg).abs() + (g - avg).abs() + (b - avg).abs()
    gray = 232 + (avg * 23) // 255
    cube = 16 + (r * 5 // 255) * 36 + (g * 5 // 255) * 6 + (b * 5 // 255)
    return torch.where(gray_diff < 30, gray, cube).to(torch.uint8)


def quantize_16(frames: torch.Tensor) -> torch.Tensor:
    """Nearest of the 16 ANSI colors; torch.argmin returns the first of equal
    minima, the reference's first-wins tie rule (ansi.c:437-477). uint8."""
    px = frames.to(torch.int32)
    pal = torch.from_numpy(ANSI16_RGB).to(frames.device)
    # squared distance summed channel by channel: [..., 16] temporaries
    # instead of a [..., 16, 3] one reduced over its short last axis
    d = torch.zeros((*px.shape[:-1], len(pal)), dtype=torch.int32, device=px.device)
    for c in range(3):
        diff = px[..., c, None] - pal[:, c]
        d += diff * diff
    return d.argmin(-1).to(torch.uint8)


def halfblock_split(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pair 2 pixel rows per cell (halfblock.c:71-88): (top, bot), each
    [..., ceil(H/2), W, C]; an odd height duplicates the last row."""
    if frames.shape[-3] % 2:
        frames = torch.cat([frames, frames[..., -1:, :, :]], dim=-3)
    return frames[..., 0::2, :, :], frames[..., 1::2, :, :]


def flip(frames: torch.Tensor, flip_x: bool = False, flip_y: bool = False) -> torch.Tensor:
    """Horizontal/vertical mirror (session display steps, display.c:549-592)."""
    if flip_x:
        frames = torch.flip(frames, dims=(-2,))
    if flip_y:
        frames = torch.flip(frames, dims=(-3,))
    return frames


def quantize_color_levels(frames: torch.Tensor, levels: int) -> torch.Tensor:
    """quantize_color (foreground.c:141-156): floor to 256/levels steps.
    Levels outside 1..256 raise: above 256 the step would be 0."""
    if not 0 < levels <= 256:
        raise ValueError(f"levels must be in 1..256, got {levels}")
    step = 256 // levels
    px = frames.to(torch.int32)
    return ((px // step) * step).to(torch.uint8)


# Bayer 4x4 matrix flattened the way the reference's NEON path consumes it:
# a 16-entry table indexed by the ROW-RELATIVE column & 15 (neon/common.c:371
# with pixel_offset = x from the row loop, neon/color.c), not a 2-D spatial
# lookup.
_BAYER16 = np.array([0, 8, 2, 10, 12, 4, 14, 6, 3, 11, 1, 9, 15, 7, 13, 5],
                    np.int32)


def ordered_dither(rgb: torch.Tensor, strength: int = 0) -> torch.Tensor:
    """Ordered (Bayer) dithering before 256-color quantization, the integer
    semantics of apply_ordered_dither (neon/common.c:369-397): channel c at
    column x gets saturating += (bayer[(x+c)&15] * strength) >> 4, the same
    for every row. The reference calls it with strength=0 (common.c:400-402)."""
    if strength == 0:
        return rgb
    w = rgb.shape[-2]
    pos = np.arange(w, dtype=np.int32)[:, None] + np.arange(3, dtype=np.int32)
    dither = torch.from_numpy((_BAYER16[pos & 15] * strength) >> 4).to(rgb.device)  # [W, 3]
    return (rgb.to(torch.int32) + dither).clamp(0, 255).to(torch.uint8)
