"""ASCII frame validator (lib/video/ascii/frame_validator.c analog).

Sanity-checks a rendered ANSI frame before it is queued for a client:
well-formed CSI sequences, visual line-width consistency, no stray control
bytes, UTF-8 validity. Used by the server path and as a test utility.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FrameReport:
    valid: bool
    lines: int
    max_visual_width: int
    sgr_count: int
    errors: list[str]


def visual_width(line: bytes) -> int:
    """TERMINAL columns consumed: skips CSI sequences, expands REP
    (``ESC[Nb``, default 1 per ECMA-48), counts UTF-8 characters.

    Deliberately NOT the same function as asciigrid.ansi_visual_width:
    that one is a byte-exact re-derivation of the reference's
    ansi_visual_width (ascii.c:527-551), which counts BYTES and ignores
    REP — required for grid-layout byte parity. This validator instead
    measures what a terminal renders, so REP-compressed and multibyte
    frames are checked against their true on-screen width."""
    width = 0
    i = 0
    n = len(line)
    while i < n:
        b = line[i]
        if b == 0x1B and i + 1 < n and line[i + 1] == ord("["):
            i += 2
            while i < n and not (0x40 <= line[i] <= 0x7E):
                i += 1
            if i < n:
                final = line[i]
                i += 1
                if final == ord("b"):  # REP: repeat previous char n times
                    j = i - 2
                    digits = b""
                    while j >= 2 and 0x30 <= line[j] <= 0x39:
                        digits = bytes([line[j]]) + digits
                        j -= 1
                    # ECMA-48: absent/zero parameter means 1 repeat
                    width += max(1, int(digits or b"1"))
        elif b == 0x1B:
            i += 1  # lone ESC (non-CSI): invisible, flagged by validate
        elif b & 0xC0 == 0x80:
            i += 1  # UTF-8 continuation
        else:
            width += 1
            i += 1
    return width


def validate_frame(frame: bytes, expect_width: int | None = None,
                   expect_height: int | None = None) -> FrameReport:
    errors: list[str] = []
    try:
        frame.decode("utf-8")
    except UnicodeDecodeError as e:
        errors.append(f"invalid UTF-8 at byte {e.start}")
    for b in frame:
        if b < 0x20 and b not in (0x0A, 0x1B):
            errors.append(f"stray control byte 0x{b:02x}")
            break
    # a trailing newline terminates the last row, it does not open a
    # phantom empty one (validate_frame(b"aa\nbb\n", height=2) is valid)
    body = frame[:-1] if frame.endswith(b"\n") else frame
    lines = body.split(b"\n")
    widths = [visual_width(ln) for ln in lines]
    sgr = frame.count(b"\x1b[")
    if expect_height is not None and len(lines) > expect_height:
        errors.append(f"too many lines: {len(lines)} > {expect_height}")
    if expect_width is not None and widths and max(widths) > expect_width:
        errors.append(f"line too wide: {max(widths)} > {expect_width}")
    # unterminated escape at end of frame (bare trailing ESC included)
    tail = frame.rfind(b"\x1b")
    if tail != -1:
        rest = frame[tail:]
        if len(rest) == 1:
            errors.append("bare ESC at end of frame")
        elif rest[1] == ord("[") and not any(0x40 <= c <= 0x7E for c in rest[2:]):
            errors.append("unterminated CSI sequence at end of frame")
    return FrameReport(
        valid=not errors,
        lines=len(lines),
        max_visual_width=max(widths) if widths else 0,
        sgr_count=sgr,
        errors=errors,
    )
