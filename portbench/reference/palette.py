"""Glyph tables of a palette string (lib/video/ascii/common.c:380-430)."""

from __future__ import annotations


def characters(palette: str) -> list[bytes]:
    """The palette's characters as the C parser splits them: the lead byte
    gives the length (2, 3 or 4 bytes, else 1); a NUL or 255 characters end it."""
    data = palette.encode("utf-8")
    chars: list[bytes] = []
    i = 0
    while i < len(data) and len(chars) < 255 and data[i] != 0:
        lead = data[i]
        step = (2 if lead & 0xE0 == 0xC0 else 3 if lead & 0xF0 == 0xE0
                else 4 if lead & 0xF8 == 0xF0 else 1)
        chars.append(data[i:i + step])
        i += step
    if not chars:
        raise ValueError("empty palette")
    return chars


def luminance_glyphs(palette: str) -> list[bytes]:
    """Glyph of each luminance 0..255: chars[(i * (n - 1) + 127) / 255]."""
    chars = characters(palette)
    n = len(chars)
    return [chars[min(n - 1, (i * (n - 1) + 127) // 255)] for i in range(256)]
