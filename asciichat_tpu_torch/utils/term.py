"""Terminal capability detection + frame output.

Re-derivation of the reference's detection logic
(detect_terminal_capabilities, include/ascii-chat/platform/terminal.h:787,
lib/platform/terminal.c): COLORTERM=truecolor/24bit -> truecolor; TERM
containing 256color -> 256; else 16; NO_COLOR disables. Frame writes go
cursor-home + full frame + flush (ascii_write, lib/video/ascii/ascii.c:392-412).
"""

from __future__ import annotations

import os
import shutil
import sys

from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities

CURSOR_HOME = b"\x1b[H"
CLEAR_SCREEN = b"\x1b[2J"
HIDE_CURSOR = b"\x1b[?25l"
SHOW_CURSOR = b"\x1b[?25h"


def detect_color_level() -> ColorLevel:
    if os.environ.get("NO_COLOR"):
        return ColorLevel.NONE
    colorterm = os.environ.get("COLORTERM", "").lower()
    if colorterm in ("truecolor", "24bit"):
        return ColorLevel.TRUECOLOR
    term = os.environ.get("TERM", "").lower()
    if "truecolor" in term or "direct" in term:
        return ColorLevel.TRUECOLOR
    if "256color" in term:
        return ColorLevel.COLOR_256
    if term in ("dumb", ""):
        return ColorLevel.NONE
    return ColorLevel.COLOR_16


def detect_utf8() -> bool:
    for var in ("LC_ALL", "LC_CTYPE", "LANG"):
        v = os.environ.get(var)
        if v:
            return "utf-8" in v.lower() or "utf8" in v.lower()
    return True


def detect_capabilities(
    render_mode: RenderMode | None = None,
    color_override: ColorLevel | None = None,
) -> TerminalCapabilities:
    level = color_override if color_override is not None else detect_color_level()
    mode = render_mode if render_mode is not None else RenderMode.FOREGROUND
    is_tty = sys.stdout.isatty()
    return TerminalCapabilities(
        color_level=level,
        render_mode=mode,
        wants_padding=is_tty,  # snapshot/piped output skips padding
        utf8_support=detect_utf8(),
    )


def terminal_size(width: int | None = None, height: int | None = None) -> tuple[int, int]:
    size = shutil.get_terminal_size(fallback=(80, 24))
    cols, lines = size.columns, size.lines
    if sys.platform == "win32" and (cols, lines) == (80, 24):
        # pragma: no cover — shutil's fallback fired (COLUMNS unset AND
        # os.get_terminal_size failed, e.g. redirected stdout on some
        # consoles): ask the Win32 console API directly
        from asciichat_tpu_torch.utils import platform_win

        win = platform_win.console_size()
        if win:
            cols, lines = win
    return width or cols, height or (lines - 1)


class FrameWriter:
    """Cursor-home frame writer with first-frame full reset (client display
    semantics, src/client/display.c)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout.buffer
        # tty behavior keys to the stream being WRITTEN, not stdout: a
        # file/devnull sink must get newline-separated frames with no
        # clear-screen codes even when stdout happens to be a terminal
        # (soak tools, DisplaySink captures), and vice versa
        probe = stream if stream is not None else sys.stdout
        try:
            self.is_tty = probe.isatty()
        except (AttributeError, ValueError, OSError):
            self.is_tty = False
        self._first = True
        self.frames_written = 0

    def setup(self) -> None:
        if self.is_tty:
            if sys.platform == "win32":  # pragma: no cover - Windows console
                # ANSI output needs VT processing enabled on Win32
                # (lib/platform/windows/terminal.c role)
                from asciichat_tpu_torch.utils import platform_win

                platform_win.enable_vt()
            self.stream.write(HIDE_CURSOR)
            self.stream.flush()

    def write_frame(self, frame: bytes) -> None:
        out = bytearray()
        if self.is_tty:
            if self._first:
                out += CLEAR_SCREEN
                self._first = False
            out += CURSOR_HOME
        out += frame
        if not self.is_tty:
            out += b"\n"
        self.stream.write(bytes(out))
        self.stream.flush()
        self.frames_written += 1

    def teardown(self) -> None:
        if self.is_tty:
            self.stream.write(SHOW_CURSOR + b"\x1b[0m\n")
            self.stream.flush()
