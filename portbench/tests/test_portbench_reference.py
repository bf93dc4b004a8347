"""The plain reference: byte for byte against the port's CPU path, its
independence from the program, and the yardstick's byte counts."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import yardstick
from reference.control import rgb565
from reference.render import Reference

FORBIDDEN_IN_REFERENCE = {"jax", "jaxlib", "flax", "asciichat_tpu", "asciichat_tpu_torch"}
STANDARD = "   ...',;:clodxkO0KXNWM"
BLOCKS = "   ░░▒▒▓▓██"  # multi-byte glyphs: the truecolor path that always writes its SGR


def config(mode: str, width: int, height: int, palette: str = STANDARD) -> dict:
    return {"mode": mode, "palette": palette, "width": width, "height": height,
            "keep_aspect": True, "padding": True}


def frames(h: int, w: int, seed: int) -> np.ndarray:
    """Noise, flat blocks (runs and repeats), black (transparent half blocks)
    and few-valued noise (short runs) in one batch."""
    rng = np.random.default_rng(seed)
    out = np.zeros((4, h, w, 3), np.uint8)
    out[0] = rng.integers(0, 256, (h, w, 3))
    out[1] = 40
    out[1, h // 4: h // 2, w // 5: w // 2] = 0
    out[1, h // 2:, w // 2:] = (200, 10, 90)
    out[2] = rng.integers(0, 3, (h, w, 1)) * 60
    out[3] = rng.integers(0, 2, (h, w, 3)) * 255
    return out


def port_frames(batch: np.ndarray, mode: str, width: int, height: int, palette: str):
    from asciichat_tpu_torch.render.pipeline import AsciiRenderer
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
    render = RenderMode.HALF_BLOCK if mode.startswith("halfblock") else RenderMode.FOREGROUND
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, render)
    return AsciiRenderer(palette=palette, device="cpu").convert_batch(batch, width, height, caps)


@pytest.mark.parametrize("palette", [STANDARD, BLOCKS])
@pytest.mark.parametrize("shape", [(48, 80, 40, 12), (80, 48, 40, 12), (45, 61, 17, 9),
                                   (1080, 1920, 203, 64)])
@pytest.mark.parametrize("mode", ["truecolor_fg", "halfblock_truecolor"])
def test_reference_equals_the_port_on_the_cpu(mode, shape, palette):
    h, w, width, height = shape
    batch = frames(h, w, seed=h * w)
    ref = Reference(config(mode, width, height, palette), h, w)
    got = port_frames(batch, mode, width, height, palette)
    assert [ref.frame(f) for f in batch] == got


def test_geometry_of_the_cells():
    tc = Reference(config("truecolor_fg", 203, 64), 1080, 1920)
    hb = Reference(config("halfblock_truecolor", 203, 64), 1080, 1920)
    assert (tc.cells_w, tc.pixel_rows, tc.pad_w, tc.pad_h) == (203, 57, 0, 3)
    assert (hb.cells_w, hb.pixel_rows, hb.pad_w, hb.pad_h) == (203, 114, 0, 3)
    tall = Reference(config("truecolor_fg", 40, 12), 80, 48)
    assert tall.pad_w > 0


def test_yardstick_counts_the_records_work():
    tc = Reference(config("truecolor_fg", 203, 64), 1080, 1920)
    hb = Reference(config("halfblock_truecolor", 203, 64), 1080, 1920)
    # sampled pixels read once (3 B), records written once (4 B or 6 B a cell)
    assert yardstick.records_bytes(tc, 128) == 128 * (57 * 203 * 3 + 57 * 203 * 4)
    assert yardstick.records_bytes(hb, 128) == 128 * (114 * 203 * 3 + 57 * 203 * 6)


def test_rgb565_control_changes_most_colours():
    values = np.arange(256, dtype=np.uint8)
    px = np.stack([values] * 3, -1)[None]
    assert (rgb565(px) != px).any(-1).mean() > 0.9


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN_IN_REFERENCE, (path, name)


def test_reference_loads_nothing_of_the_program():
    probe = (
        "import sys, json, numpy as np; sys.path.insert(0, sys.argv[1]);"
        "from reference.render import Reference; from reference.control import Rgb565Reference;"
        "f = np.random.default_rng(0).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8);"
        "[[cls(json.loads(c), 48, 80).frame(x) for x in f]"
        " for c in sys.argv[2:] for cls in (Reference, Rgb565Reference)];"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    confs = [json.dumps(config(m, 40, 12)) for m in ("truecolor_fg", "halfblock_truecolor")]
    proc = subprocess.run([sys.executable, "-c", probe, str(BENCH_DIR), *confs],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(eval(proc.stdout.strip()))
    assert "reference" in loaded and not loaded & FORBIDDEN_IN_REFERENCE
