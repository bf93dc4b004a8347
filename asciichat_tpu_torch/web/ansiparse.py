"""Python twin of the browser render core's ANSI parser (web/ansi.js).

Same algorithm, same state machine, same color resolution — kept
structurally in sync with ansi.js so the golden tests below transfer: this
twin is byte-golden-tested against the oracle renderers across every render
mode (tests/test_webclient.py), and ansi.js is the line-for-line port (run
directly against the same JSON corpus when a node interpreter is available).

Grammar sources (reference file:line): SGR/REP emission
lib/video/ascii/output_buffer.c:107-164; 16/256-color SGR + palettes
lib/video/terminal/ansi.c:360-583; frame shapes lib/video/ascii/ascii.c.
"""

from __future__ import annotations

import numpy as np

# 16-color ANSI palette (ansi.c:442-459; also xterm256 indices 0-15)
ANSI16 = [
    0x000000, 0x800000, 0x008000, 0x808000,
    0x000080, 0x800080, 0x008080, 0xC0C0C0,
    0x808080, 0xFF0000, 0x00FF00, 0xFFFF00,
    0x0000FF, 0xFF00FF, 0x00FFFF, 0xFFFFFF,
]
_CUBE = [0, 95, 135, 175, 215, 255]
SPACE = 32


def xterm256(n: int) -> int:
    if n < 16:
        return ANSI16[n & 15]
    if n < 232:
        c = n - 16
        return (_CUBE[c // 36] << 16) | (_CUBE[(c // 6) % 6] << 8) | _CUBE[c % 6]
    v = 8 + (n - 232) * 10
    return (v << 16) | (v << 8) | v


class AnsiGrid:
    """Cell grid parsed from one ANSI frame: glyph codepoints + packed
    0xRRGGBB fg/bg (-1 = none/default), row-major with stride cap_w."""

    def __init__(self, cap_w: int = 256, cap_h: int = 128):
        self.cap_w = cap_w
        self.cap_h = cap_h
        self._alloc()
        self.w = 0
        self.h = 0
        self.all_halfblock = True

    def _alloc(self) -> None:
        n = self.cap_w * self.cap_h
        self.glyphs = np.full(n, SPACE, dtype=np.uint32)
        self.fg = np.full(n, -1, dtype=np.int32)
        self.bg = np.full(n, -1, dtype=np.int32)

    def parse(self, frame: bytes | str) -> "AnsiGrid":
        text = frame.decode("utf-8") if isinstance(frame, bytes) else frame
        cap_w, cap_h = self.cap_w, self.cap_h
        used = cap_w * min(self.h + 1, cap_h)
        self.glyphs[:used] = SPACE
        self.fg[:used] = -1
        self.bg[:used] = -1
        glyphs, fg_arr, bg_arr = self.glyphs, self.fg, self.bg
        fg = bg = -1
        row = col = max_col = 0
        last_glyph, last_fg, last_bg = SPACE, -1, -1
        all_hb = True
        n_chars = len(text)
        i = 0
        while i < n_chars:
            c = text[i]
            if c == "\x1b" and i + 1 < n_chars and text[i + 1] == "[":
                j = i + 2
                params: list[int] = []
                num = -1
                fin = ""
                while j < n_chars:
                    d = text[j]
                    if "0" <= d <= "9":
                        num = (0 if num < 0 else num) * 10 + ord(d) - 48
                    elif d == ";":
                        params.append(0 if num < 0 else num)
                        num = -1
                    else:
                        fin = d
                        break
                    j += 1
                if num >= 0:
                    params.append(num)
                # cap at 5 (the longest oracle form, 38;2;R;G;B) — identical
                # to the JS register-based accumulator
                del params[5:]
                if fin == "m":
                    if not params:
                        fg = bg = -1
                    elif len(params) == 5 and params[0] == 38 and params[1] == 2:
                        fg = ((params[2] & 255) << 16) | ((params[3] & 255) << 8) \
                            | (params[4] & 255)
                    elif len(params) == 5 and params[0] == 48 and params[1] == 2:
                        bg = ((params[2] & 255) << 16) | ((params[3] & 255) << 8) \
                            | (params[4] & 255)
                    elif len(params) == 3 and params[0] == 38 and params[1] == 5:
                        fg = xterm256(params[2] & 255)
                    elif len(params) == 3 and params[0] == 48 and params[1] == 5:
                        bg = xterm256(params[2] & 255)
                    else:
                        for p in params:
                            if p == 0:
                                fg = bg = -1
                            elif 30 <= p <= 37:
                                fg = ANSI16[p - 30]
                            elif 90 <= p <= 97:
                                fg = ANSI16[p - 90 + 8]
                            elif 40 <= p <= 47:
                                bg = ANSI16[p - 40]
                            elif 100 <= p <= 107:
                                bg = ANSI16[p - 100 + 8]
                elif fin == "b":  # REP: repeat last glyph
                    reps = params[0] if params else 0
                    # REP must trigger the same grid-doubling realloc a
                    # literal glyph gets: silently truncating at cap_w lost
                    # the right side of uniform rows wider than the initial
                    # capacity (kept in lockstep with ansi.js — shared
                    # corpus contract)
                    if reps > 0 and col + min(reps, 4096) > cap_w and row < cap_h:
                        self.cap_w = cap_w * 2
                        self._alloc()
                        return self.parse(text)
                    while reps > 0 and col < cap_w and row < cap_h:
                        at = row * cap_w + col
                        glyphs[at] = last_glyph
                        fg_arr[at] = last_fg
                        bg_arr[at] = last_bg
                        col += 1
                        reps -= 1
                    max_col = max(max_col, col)
                i = j + 1
                continue
            if c == "\n":
                row += 1
                col = 0
                if row >= cap_h:
                    self.cap_h = cap_h * 2
                    self._alloc()
                    return self.parse(text)
                i += 1
                continue
            cp = ord(c)
            if col >= cap_w:
                self.cap_w = cap_w * 2
                self._alloc()
                return self.parse(text)
            at = row * cap_w + col
            glyphs[at] = cp
            fg_arr[at] = fg
            bg_arr[at] = bg
            last_glyph, last_fg, last_bg = cp, fg, bg
            if cp != SPACE and cp != 0x2580:
                all_hb = False
            col += 1
            max_col = max(max_col, col)
            i += 1
        self.w = max_col
        self.h = row + 1
        self.all_halfblock = all_hb
        return self

    def cell(self, x: int, y: int) -> tuple[int, int, int]:
        at = y * self.cap_w + x
        return int(self.glyphs[at]), int(self.fg[at]), int(self.bg[at])

    def cells(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(glyphs, fg, bg) each [h, w] — the grid without the stride."""
        g = self.glyphs.reshape(-1, self.cap_w)[: self.h, : self.w]
        f = self.fg.reshape(-1, self.cap_w)[: self.h, : self.w]
        b = self.bg.reshape(-1, self.cap_w)[: self.h, : self.w]
        return g.copy(), f.copy(), b.copy()
