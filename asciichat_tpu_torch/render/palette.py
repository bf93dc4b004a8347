"""UTF-8 glyph palettes and lookup-table construction.

Byte-exact re-derivation of the reference's palette caches:

- built-in palettes:            lib/video/ascii/palette.c:25-45,
                                include/ascii-chat/video/ascii/palette.h:161-197
- UTF-8 char parsing:           lib/video/ascii/common.c:392-412 (lead-byte lengths,
                                invalid bytes treated as single-byte)
- 256-entry luminance cache:    build_utf8_luminance_cache, common.c:380-430
  (cache[i] = chars[(i*(count-1)+127)/255])
- 64-entry ramp + index ramp:   build_utf8_ramp64_cache, common.c:433-490
  (char_index_ramp[i] = (i*(count-1)+31)/63; cache64[i] = chars[char_index_ramp[i]])

Production quirk we must replicate exactly (see render/oracle.py): the mono
renderer indexes ``cache64`` by ``char_index_ramp[luma>>2]`` — a *palette*
index, not a luma bucket (scalar/foreground.c:97-102) — i.e. a double
indirection ``chars[ramp[ramp[luma>>2]]]``; the 16-color renderers index the
256-entry ``cache`` by the palette index (scalar 16color, foreground.c:597-599).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Built-in palettes (palette.h:161-197). Lengths are *characters*, not bytes.
PALETTE_STANDARD = "   ...',;:clodxkO0KXNWM"
PALETTE_BLOCKS = "   ░░▒▒▓▓██"
PALETTE_DIGITAL = "   -=≡≣▰▱◼"
PALETTE_MINIMAL = "   .-+*#"
PALETTE_COOL = "   ▁▂▃▄▅▆▇█"

BUILTIN_PALETTES = {
    "standard": PALETTE_STANDARD,
    "blocks": PALETTE_BLOCKS,
    "digital": PALETTE_DIGITAL,
    "minimal": PALETTE_MINIMAL,
    "cool": PALETTE_COOL,
}

DEFAULT_PALETTE = PALETTE_STANDARD


def parse_utf8_chars(palette: str | bytes) -> list[bytes]:
    """Split a palette byte string into characters the way the reference does.

    Lead-byte driven: 0b110xxxxx -> 2 bytes, 0b1110xxxx -> 3, 0b11110xxx -> 4,
    anything else (ASCII or invalid) -> 1 byte (common.c:392-412). Stops at 255
    characters. No validation of continuation bytes — the parser can read past
    a truncated sequence exactly like the C code's pointer arithmetic would;
    we clip to the end of the buffer.
    """
    data = palette.encode("utf-8") if isinstance(palette, str) else bytes(palette)
    chars: list[bytes] = []
    i = 0
    n = len(data)
    while i < n and len(chars) < 255:
        b = data[i]
        if b == 0:
            # the reference parser is NUL-terminated (common.c:394
            # `while (*p && char_count < 255)`): an embedded NUL ends the
            # palette; parsing past it built LUTs no C build could ever see
            break
        if (b & 0xE0) == 0xC0:
            step = 2
        elif (b & 0xF0) == 0xE0:
            step = 3
        elif (b & 0xF8) == 0xF0:
            step = 4
        else:
            step = 1
        chars.append(data[i : min(i + step, n)])
        i += step
    return chars


@dataclasses.dataclass(frozen=True)
class PaletteCache:
    """All LUTs derived from one palette string (reference utf8_palette_cache_t)."""

    palette: str
    chars: tuple[bytes, ...]
    # cache256[i]: glyph for direct luminance lookup (truecolor/256color paths)
    cache256: tuple[bytes, ...]
    # char_index_ramp[i] for i in 0..63: luma bucket -> palette char index
    char_index_ramp: tuple[int, ...]
    # cache64[i]: glyph at palette index char_index_ramp[i] (indexed by *palette
    # index* in the mono path — the production double indirection)
    cache64: tuple[bytes, ...]

    @property
    def char_count(self) -> int:
        return len(self.chars)

    def mono_glyphs(self) -> tuple[bytes, ...]:
        """glyph bytes for each possible mono run key (palette char index 0..63).

        Mono run key k = char_index_ramp[luma>>2]; glyph = cache64[k]
        (scalar/foreground.c:97-102). Only keys that are < 64 are reachable
        without invoking C undefined behaviour; we require char_count <= 64.
        """
        if self.char_count > 64:
            raise ValueError(
                "palettes with more than 64 characters index cache64 out of "
                "bounds in the reference mono renderer (undefined behaviour); "
                "refusing to reproduce"
            )
        return self.cache64


@functools.lru_cache(maxsize=256)
def get_palette_cache(palette: str) -> PaletteCache:
    chars = parse_utf8_chars(palette)
    count = len(chars)
    if count == 0:
        raise ValueError("empty palette")

    # 256-entry luminance cache (common.c:419-429)
    cache256 = []
    for i in range(256):
        ci = (i * (count - 1) + 127) // 255 if count > 1 else 0
        ci = min(ci, count - 1)
        cache256.append(chars[ci])

    # 64-entry ramp + palette-index ramp (common.c:475-489)
    ramp = []
    cache64 = []
    for i in range(64):
        ci = (i * (count - 1) + 31) // 63 if count > 1 else 0
        ci = min(ci, count - 1)
        ramp.append(ci)
        cache64.append(chars[ci])
    # char_index_ramp is uint8_t[256] in C but only [0..63] is written/read.
    # cache64 is indexed by *palette index* values in the mono path; palette
    # indices beyond 63 would be OOB in C. We keep the 64 entries and guard in
    # mono_glyphs().

    return PaletteCache(
        palette=palette,
        chars=tuple(chars),
        cache256=tuple(cache256),
        char_index_ramp=tuple(ramp),
        cache64=tuple(cache64),
    )


def char_index_ramp_array(palette: str) -> np.ndarray:
    """char_index_ramp as uint8[64] for device-side luma->key mapping."""
    return np.asarray(get_palette_cache(palette).char_index_ramp, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Packed glyph tables for the native emitter: each entry is 5 bytes
# (len, b0, b1, b2, b3), row-major uint8 [N, 5].


def packed_glyph_table(glyphs: tuple[bytes, ...] | list[bytes], size: int) -> np.ndarray:
    table = np.zeros((size, 5), dtype=np.uint8)
    for i in range(min(size, len(glyphs))):
        g = glyphs[i]
        table[i, 0] = len(g)
        table[i, 1 : 1 + len(g)] = np.frombuffer(g, dtype=np.uint8)
    return table


def mono_glyph_table(palette: str) -> np.ndarray:
    """uint8[64,5] glyph table indexed by the mono run key (palette index)."""
    return packed_glyph_table(get_palette_cache(palette).mono_glyphs(), 64)


def luminance_glyph_table(palette: str) -> np.ndarray:
    """uint8[256,5] glyph table indexed by clamped luminance (truecolor/256)."""
    return packed_glyph_table(get_palette_cache(palette).cache256, 256)
