"""One frame through the reference: geometry, resize, the mode's bytes, padding."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

import numpy as np

from reference import geometry

MODES_DIR = Path(__file__).resolve().parent / "modes"


def load_mode(mode: str) -> ModuleType:
    """``modes/<mode>.py``: ROWS_PER_CELL, RECORD_BYTES_PER_CELL and
    ``render(pixels, palette) -> bytes``."""
    path = MODES_DIR / f"{mode}.py"
    if not path.is_file():
        raise ValueError(f"no reference mode {mode!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"reference.modes.{mode}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Reference:
    """The reference conversion of one configuration (see ``configs/*.json``)."""

    def __init__(self, config: dict, source_h: int, source_w: int):
        self.mode = load_mode(config["mode"])
        self.palette = config["palette"]
        self.cells_w, self.pixel_rows, self.pad_w, self.pad_h = geometry.render_geometry(
            source_w, source_h, config["width"], config["height"],
            self.mode.ROWS_PER_CELL, config["keep_aspect"], config["padding"])
        self.sy = geometry.resize_indices(source_h, self.pixel_rows)
        self.sx = geometry.resize_indices(source_w, self.cells_w)

    def resize(self, frame: np.ndarray) -> np.ndarray:
        return frame[self.sy][:, self.sx]

    def frame(self, frame: np.ndarray) -> bytes:
        """uint8 [H, W, 3] source -> the ANSI frame the program must return."""
        body = self.mode.render(self.resize(frame), self.palette)
        return geometry.pad(body, self.pad_w, self.pad_h)
