"""Color filters: the registry, the host planners and the plain batched filter.

The registry and host functions are copied from
``asciichat_tpu/ops/filters.py:25-107,131-147`` (that module imports JAX at
the top); tests hold each copy equal to its original. The integer semantics
are lib/video/rgba/color_filter.c: grayscale (77,150,29)>>8 with NO rounding
constant (color_filter.h:172-174), and the colorize modes of
color_filter.c:257-271:

  foreground_on_bg (dark-on-light): out = (tint*(255-gray) + 255*gray) / 255
  else (tint-on-black):             out = (tint*gray) / 255

Rainbow cycles hue over 3.5 s with a min-luminance boost
(color_filter.c:169-243) and uses a 179 min-brightness gray pre-boost
(color_filter.c:290-317). K3 (``csrc/render_group.cu``) fuses the filter into
the server's render; :func:`apply_color_filter` is its plain version.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

# (name, (r, g, b), foreground_on_bg) — color_filter.c:23-142
FILTER_REGISTRY: dict[str, tuple[tuple[int, int, int], bool]] = {
    "none": ((0, 0, 0), False),
    "black": ((0, 0, 0), True),
    "white": ((255, 255, 255), False),
    "green": ((0, 255, 65), False),
    "magenta": ((255, 0, 255), False),
    "fuchsia": ((255, 0, 170), False),
    "orange": ((255, 136, 0), False),
    "teal": ((0, 221, 221), False),
    "cyan": ((0, 255, 255), False),
    "pink": ((255, 182, 193), False),
    "red": ((255, 51, 51), False),
    "yellow": ((255, 235, 153), False),
    "rainbow": ((255, 0, 0), False),  # color computed from time
}
FILTER_NAMES = list(FILTER_REGISTRY)
RAINBOW_MIN_BRIGHTNESS = 179  # 70% of 255 (color_filter.c:301)


_F32 = struct.Struct("<f")


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (ties to even), as a Python float."""
    return _F32.unpack(_F32.pack(x))[0]


_LUM = tuple(_f32(c) for c in (0.2126, 0.7152, 0.0722))  # float32 luminance weights


def rainbow_color(time_s: float) -> tuple[int, int, int]:
    """HSV sweep over 3.5 s + min-luminance 120 boost (color_filter.c:169-243),
    evaluated in float32 like the C ground truth (fmodf / float arithmetic).
    Each step runs in double and is rounded to float32, which gives the
    float32 result exactly: a sum, difference, product or quotient of two
    float32 values is correctly rounded that way, and fmod and floor are
    exact. (Python floats in place of numpy float32 scalars: the server
    takes this every tick.)"""
    phase = _f32(_f32(math.fmod(_f32(time_s), 3.5)) / 3.5)
    h = _f32(_f32(phase * 360.0) / 60.0)
    i = math.floor(h)
    f = _f32(h - i)
    q, t = _f32(1.0 - f), f
    # C `i % 6` truncates toward zero: a negative time gives a negative
    # remainder, which falls to the switch's `default: red`
    # (color_filter.c:220-225)
    seg = i - int(i / 6) * 6
    if seg == 0:
        r, g, b = 255, int(_f32(_f32(t * 255.0) + 0.5)), 0
    elif seg == 1:
        r, g, b = int(_f32(_f32(q * 255.0) + 0.5)), 255, 0
    elif seg == 2:
        r, g, b = 0, 255, int(_f32(_f32(t * 255.0) + 0.5))
    elif seg == 3:
        r, g, b = 0, int(_f32(_f32(q * 255.0) + 0.5)), 255
    elif seg == 4:
        r, g, b = int(_f32(_f32(t * 255.0) + 0.5)), 0, 255
    elif seg == 5:
        r, g, b = 255, 0, int(_f32(_f32(q * 255.0) + 0.5))
    else:  # negative segment: the C default case
        r, g, b = 255, 0, 0
    # min-luminance boost in float32, rounding at every step like the C
    lum = _f32(_f32(_f32(_LUM[0] * r) + _f32(_LUM[1] * g)) + _f32(_LUM[2] * b))
    if lum < 120.0:
        boost = _f32(_f32(120.0 - lum) / 3.0)
        r = int(min(255.0, _f32(r + boost)))
        g = int(min(255.0, _f32(g + boost)))
        b = int(min(255.0, _f32(b + boost)))
    return r, g, b


def filter_params(names: list[str], time_s: float = 0.0
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-receiver filter vectors: tint [C,3] i32, fg_on_bg [C] bool,
    is_rainbow [C] bool, enabled [C] bool."""
    tint = np.zeros((len(names), 3), np.int32)
    fg_on_bg = np.zeros(len(names), bool)
    is_rainbow = np.zeros(len(names), bool)
    enabled = np.zeros(len(names), bool)
    for i, name in enumerate(names):
        rgb, mode = FILTER_REGISTRY[name]
        if name == "rainbow":
            rgb = rainbow_color(time_s)
            is_rainbow[i] = True
        tint[i] = rgb
        fg_on_bg[i] = mode
        enabled[i] = name != "none"
    return tint, fg_on_bg, is_rainbow, enabled


def apply_color_filter(
    frames: torch.Tensor,  # uint8 [C, H, W, 3]
    tint: torch.Tensor,  # int32 [C, 3]
    fg_on_bg: torch.Tensor,  # bool [C]
    is_rainbow: torch.Tensor,  # bool [C]
    enabled: torch.Tensor,  # bool [C]
) -> torch.Tensor:
    """Batched per-receiver colorize (apply_color_filter, color_filter.c:274-345)."""
    px = frames.to(torch.int32)
    gray = (77 * px[..., 0] + 150 * px[..., 1] + 29 * px[..., 2]) >> 8  # [C,H,W]
    # rainbow pre-boost: adjusted = 179 + gray*(255-179)/255 (color_filter.c:310-315)
    boosted = RAINBOW_MIN_BRIGHTNESS + (gray * (255 - RAINBOW_MIN_BRIGHTNESS)) // 255
    g = torch.where(is_rainbow[:, None, None], boosted, gray)[..., None]  # [C,H,W,1]
    t = tint.to(torch.int32)[:, None, None, :]  # [C,1,1,3]
    on_bg = (t * (255 - g) + 255 * g) // 255
    on_black = (t * g) // 255
    out = torch.where(fg_on_bg[:, None, None, None], on_bg, on_black).to(torch.uint8)
    return torch.where(enabled[:, None, None, None], out, frames)


def apply_color_filter_reference(frame: np.ndarray, name: str, time_s: float = 0.0) -> np.ndarray:
    """Per-pixel numpy reference (color_filter.c loop semantics)."""
    if name == "none":
        return frame.copy()
    rgb, fg_on_bg = FILTER_REGISTRY[name]
    if name == "rainbow":
        rgb = rainbow_color(time_s)
    out = frame.astype(np.int64)
    gray = (77 * out[..., 0] + 150 * out[..., 1] + 29 * out[..., 2]) >> 8
    if name == "rainbow":
        gray = RAINBOW_MIN_BRIGHTNESS + (gray * (255 - RAINBOW_MIN_BRIGHTNESS)) // 255
    t = np.asarray(rgb, np.int64)
    if fg_on_bg:
        res = (t * (255 - gray[..., None]) + 255 * gray[..., None]) // 255
    else:
        res = (t * gray[..., None]) // 255
    return res.astype(np.uint8)
