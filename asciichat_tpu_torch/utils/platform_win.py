"""Windows console backend (lib/platform/windows/terminal.c role).

The reference ships a full Win32 console layer (~1.3k LoC: VT enable, raw
keyboard via ReadConsoleInput, size queries). This module provides the same
capabilities through the documented kernel32 console API via ctypes:

- `enable_vt()` — turn on ENABLE_VIRTUAL_TERMINAL_PROCESSING so ANSI/SGR
  escape output renders (Windows 10 1511+; before that the renderer's
  output would print as literal escapes — callers fall back to mono).
- `raw_keyboard()` — clear line/echo/processed input on the console and
  enable VT input so arrow keys arrive as ESC sequences, restoring the
  previous mode on exit.
- `console_size()` — GetConsoleScreenBufferInfo's window rectangle.

All Win32 calls are isolated behind `_k32()`; the mode arithmetic is pure
(`vt_output_mode`, `raw_input_mode`) and unit-tested on every platform.
This module imports everywhere; only the functions touching the console
require Windows (they raise OSError elsewhere).
"""

from __future__ import annotations

import contextlib
import ctypes
import sys

# Win32 console constants (wincon.h, stable documented ABI)
STD_INPUT_HANDLE = -10
STD_OUTPUT_HANDLE = -11
ENABLE_PROCESSED_INPUT = 0x0001
ENABLE_LINE_INPUT = 0x0002
ENABLE_ECHO_INPUT = 0x0004
ENABLE_VIRTUAL_TERMINAL_INPUT = 0x0200
ENABLE_PROCESSED_OUTPUT = 0x0001
ENABLE_VIRTUAL_TERMINAL_PROCESSING = 0x0004
DISABLE_NEWLINE_AUTO_RETURN = 0x0008


def vt_output_mode(current: int) -> int:
    """Output mode with ANSI rendering on: VT processing + no auto-CR
    munging (the emitter writes exact bytes incl. '\\n' row separators),
    keeping whatever else the host console had enabled."""
    return (current
            | ENABLE_PROCESSED_OUTPUT
            | ENABLE_VIRTUAL_TERMINAL_PROCESSING
            | DISABLE_NEWLINE_AUTO_RETURN)


def raw_input_mode(current: int) -> int:
    """Input mode for per-key reads: no line buffering, no echo, no ^C
    cooking, VT input so cursor keys arrive as ESC sequences (matching the
    POSIX termios-raw path in utils/keyboard.py)."""
    return ((current
             & ~(ENABLE_PROCESSED_INPUT | ENABLE_LINE_INPUT
                 | ENABLE_ECHO_INPUT))
            | ENABLE_VIRTUAL_TERMINAL_INPUT)


def _k32():
    if sys.platform != "win32":  # pragma: no cover - exercised on Windows
        raise OSError("Win32 console API requires Windows")
    return ctypes.windll.kernel32  # type: ignore[attr-defined]


def enable_vt() -> bool:  # pragma: no cover - requires a Windows console
    """Enable ANSI escape rendering on stdout. False on legacy consoles
    (pre-1511) — the caller should degrade to ColorLevel.NONE."""
    try:
        k32 = _k32()
        h = k32.GetStdHandle(STD_OUTPUT_HANDLE)
        mode = ctypes.c_uint32(0)
        if not k32.GetConsoleMode(h, ctypes.byref(mode)):
            return False
        return bool(k32.SetConsoleMode(h, vt_output_mode(mode.value)))
    except OSError:
        return False


@contextlib.contextmanager
def raw_keyboard():  # pragma: no cover - requires a Windows console
    """Context manager: console in raw per-key mode, restored on exit."""
    k32 = _k32()
    h = k32.GetStdHandle(STD_INPUT_HANDLE)
    saved = ctypes.c_uint32(0)
    if not k32.GetConsoleMode(h, ctypes.byref(saved)):
        raise OSError("GetConsoleMode failed")
    k32.SetConsoleMode(h, raw_input_mode(saved.value))
    try:
        yield
    finally:
        k32.SetConsoleMode(h, saved.value)


def console_size() -> tuple[int, int] | None:  # pragma: no cover - Windows
    """(columns, rows) of the visible console window, None off-console."""

    class _Coord(ctypes.Structure):
        _fields_ = [("X", ctypes.c_short), ("Y", ctypes.c_short)]

    class _SmallRect(ctypes.Structure):
        _fields_ = [("Left", ctypes.c_short), ("Top", ctypes.c_short),
                    ("Right", ctypes.c_short), ("Bottom", ctypes.c_short)]

    class _CSBI(ctypes.Structure):
        _fields_ = [("dwSize", _Coord), ("dwCursorPosition", _Coord),
                    ("wAttributes", ctypes.c_ushort), ("srWindow", _SmallRect),
                    ("dwMaximumWindowSize", _Coord)]

    try:
        k32 = _k32()
        info = _CSBI()
        h = k32.GetStdHandle(STD_OUTPUT_HANDLE)
        if not k32.GetConsoleScreenBufferInfo(h, ctypes.byref(info)):
            return None
        return (info.srWindow.Right - info.srWindow.Left + 1,
                info.srWindow.Bottom - info.srWindow.Top + 1)
    except OSError:
        return None
