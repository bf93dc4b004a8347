#!/usr/bin/env python3
"""Write the glyph atlas that the port's ``--render-file`` rasters with.

    python3 tools/make_glyph_atlas.py [OUT]

Rasterizes ASCII 32..127 with PIL's built-in font (``ImageFont.load_default``),
each glyph in a cell as tall and as wide as the largest glyph's box, and saves
the ink coverage as uint8 [96, gh, gw] to ``OUT`` (default
``asciichat_tpu_torch/models/glyph_atlas.npy``). The loop is
``asciichat_tpu/models/renderfile.glyph_atlas``'s, so the file equals that
function's atlas under the same PIL; ``tests/test_torch_renderfile.py`` holds
it so. The port loads the file and never imports PIL: the atlas depends on
which font PIL has (with FreeType, a 12x10 cell; without, its old bitmap font
at another size), so it is fixed once here.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw, ImageFont

OUT = Path(__file__).resolve().parent.parent / "asciichat_tpu_torch" / "models" / "glyph_atlas.npy"


def make_atlas() -> np.ndarray:
    font = ImageFont.load_default()
    gw = gh = 0
    for code in range(32, 128):
        box = font.getbbox(chr(code))
        gw = max(gw, box[2])
        gh = max(gh, box[3])
    atlas = np.zeros((96, gh, gw), np.uint8)
    for code in range(32, 128):
        img = Image.new("L", (gw, gh), 0)
        ImageDraw.Draw(img).text((0, 0), chr(code), fill=255, font=font)
        atlas[code - 32] = np.asarray(img, np.uint8)
    return atlas


def main() -> int:
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else OUT
    atlas = make_atlas()
    np.save(out, atlas, allow_pickle=False)
    print(f"wrote {out}: uint8 {list(atlas.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
