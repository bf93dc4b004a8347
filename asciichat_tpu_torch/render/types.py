"""Terminal capability types.

Mirrors the reference's dispatch-relevant capability surface:
``include/ascii-chat/platform/terminal.h:580-666`` (color levels, render modes)
and the fields consumed by ``image_print_with_capabilities``
(``lib/video/ascii/ascii.c:955-1002``) and ``ascii_convert_with_capabilities``
(``ascii.c:194-253``).
"""

from __future__ import annotations

import dataclasses
import enum


class ColorLevel(enum.IntEnum):
    """Terminal color depth (reference ``terminal_color_mode_t``, terminal.h:580-588)."""

    AUTO = -1
    NONE = 0
    COLOR_16 = 1
    COLOR_256 = 2
    TRUECOLOR = 3


class RenderMode(enum.IntEnum):
    """Renderer family (reference ``render_mode_t``, terminal.h:662-666)."""

    FOREGROUND = 0
    BACKGROUND = 1
    HALF_BLOCK = 2


@dataclasses.dataclass(frozen=True)
class TerminalCapabilities:
    """Per-client terminal capabilities driving renderer dispatch.

    Matches the subset of ``terminal_capabilities_t`` used by the render path:
    color_level x render_mode select the producer (ascii.c:955-1002), and
    wants_padding gates centering (ascii.c:238-253).
    """

    color_level: ColorLevel = ColorLevel.TRUECOLOR
    render_mode: RenderMode = RenderMode.FOREGROUND
    wants_padding: bool = True
    utf8_support: bool = True

    def renderer_key(self) -> str:
        """Stable string key naming the producer, mirroring the reference dispatch.

        Reference ground truth (SURVEY.md A.1): half-block dispatches by color
        depth; TRUECOLOR+FG goes through image_print_color_simd which falls
        through to the scalar truecolor RLE renderer; TRUECOLOR+BG falls through
        to the 16-color dithered background renderer (sgr.c:413-436).
        """
        if self.render_mode == RenderMode.HALF_BLOCK:
            return {
                ColorLevel.TRUECOLOR: "halfblock_truecolor",
                ColorLevel.COLOR_256: "halfblock_256",
                ColorLevel.COLOR_16: "halfblock_16",
            }.get(self.color_level, "halfblock_mono")
        if self.color_level == ColorLevel.TRUECOLOR:
            if self.render_mode == RenderMode.BACKGROUND:
                return "16color_dithered_bg"
            return "truecolor_fg"
        if self.color_level == ColorLevel.COLOR_256:
            return "256color"
        if self.color_level == ColorLevel.COLOR_16:
            return "16color"
        return "mono"
