#!/usr/bin/env python
"""Regenerate tests/data/ansi_corpus.json from the PyTorch port's oracle
(``asciichat_tpu_torch/render/oracle.py``) and ANSI parser
(``asciichat_tpu_torch/web/ansiparse.py``).

The counterpart of tools/gen_ansi_corpus.py. The corpus is the shared
contract that keeps ``web/ansi.js`` and its Python twin in lockstep: each
entry is {name, text, w, h, cells}, where ``text`` is an ANSI frame (oracle
output in every render mode, plus handcrafted parser edge cases) and
``cells`` the parsed grid [[codepoint, fg, bg], ...] row-major (-1 = unset
colour). Generated from the port's modules, it equals the committed file
byte for byte (tests/test_torch_web.py holds it so).

Usage: python tools/torch_gen_ansi_corpus.py   (rewrites tests/data/ansi_corpus.json)
"""

from __future__ import annotations

import json
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from asciichat_tpu_torch.render import oracle  # noqa: E402
from asciichat_tpu_torch.render import palette as pal  # noqa: E402
from asciichat_tpu_torch.web import ansiparse  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "ansi_corpus.json")

# every oracle grammar (render/oracle.py, reference scalar/*.c)
RENDERS = {
    "mono": oracle.render_mono,
    "truecolor_fg": oracle.render_truecolor_fg,
    "truecolor_fg_utf8": oracle.render_truecolor_fg_utf8,
    "256color": oracle.render_256color,
    "16color": oracle.render_16color,
    "16color_dithered": oracle.render_16color_dithered,
    "16color_dithered_bg":
        lambda rgb, palette: oracle.render_16color_dithered_bg(rgb, True, palette),
    "halfblock_truecolor": lambda rgb, palette: oracle.render_halfblock_truecolor(rgb),
    "halfblock_256": oracle.render_halfblock_256,
    "halfblock_16": oracle.render_halfblock_16,
}

# handcrafted parser edge cases (REP across SGR, clear+home overdraw,
# REP at end-of-input, utf8 glyph + REP, parameterless SGR)
EDGES = [
    ("rep_across_sgr", "\x1b[38;2;1;2;3mA\x1b[3b\x1b[mB"),
    ("clear_home_overdraw", "\x1b[97m\x1b[41mZ\x1b[2J\x1b[HX"),
    ("rep_trailing", "Q\x1b[5b"),
    ("utf8_rep", "\x1b[38;2;9;8;7m▀\x1b[2b."),
    ("bare_sgr_reset", "ab\x1b[mc\nd\x1b[48;5;17me"),
    ("crlf_and_blank_lines", "x\r\n\r\ny\x1b[0m\n"),
]


def _frames(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = int(rng.integers(3, 12)), int(rng.integers(4, 20))
        kind = rng.integers(0, 3)
        if kind == 0:
            yield rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        elif kind == 1:  # flat runs (RLE/REP paths)
            rgb = np.zeros((h, w, 3), np.uint8)
            for _ in range(int(rng.integers(1, 5))):
                y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
                rgb[y0:, x0:] = rng.integers(0, 256, 3, dtype=np.uint8)
            yield rgb
        else:  # gradient
            yy, xx = np.mgrid[0:h, 0:w]
            yield np.stack([xx * 255 // max(w - 1, 1),
                            yy * 255 // max(h - 1, 1),
                            (xx + yy) % 256], -1).astype(np.uint8)


def entry(name: str, text: str) -> dict:
    grid = ansiparse.AnsiGrid().parse(text)
    cells = [list(grid.cell(x, y))
             for y in range(grid.h) for x in range(grid.w)]
    return {"name": name, "text": text, "w": grid.w, "h": grid.h,
            "cells": cells}


def corpus() -> dict:
    entries = []
    for mode, render in sorted(RENDERS.items()):
        for i, rgb in enumerate(_frames(zlib.crc32(mode.encode()), n=2)):
            text = render(rgb, pal.DEFAULT_PALETTE).decode()
            entries.append(entry(f"{mode}_{i}", text))
    for name, text in EDGES:
        entries.append(entry(f"edge_{name}", text))
    return {"version": 1, "entries": entries}


def dumps(obj: dict) -> str:
    """The file's exact text."""
    return json.dumps(obj, indent=None, separators=(",", ":")) + "\n"


def main() -> None:
    obj = corpus()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(dumps(obj))
    print(f"wrote {len(obj['entries'])} entries -> {OUT} "
          f"({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
