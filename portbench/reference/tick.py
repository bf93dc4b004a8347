"""The frames one video tick of the server sends, from its sources' frames.

Each receiver's frame is its terminal's grid composite of the sources
(grid.py), through its colour filter (filters.py), rendered in its mode
(modes/<mode>.py) with its palette, or the server's where it names none, and
padded. Receivers that share a terminal geometry, a mode and a palette share
the composite; receivers that also share a filter share the frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from reference import filters, geometry, grid
from reference.render import load_mode


@dataclasses.dataclass(eq=False)
class View:
    """A geometry group's composite in one receiver's terminal."""

    key: tuple  # (width, height, mode, palette)
    mode: object  # the mode's module
    palette: str
    src: np.ndarray  # [pixel rows, cells] source of each output pixel, -1 background
    sy: np.ndarray
    sx: np.ndarray
    pad_w: int
    pad_h: int


class TickReference:
    """The frames of a configuration's receivers (``config["clients"]``, in
    order) for sources of ``sizes`` ((w, h) each, in the clients' order)."""

    def __init__(self, config: dict, sizes: list[tuple[int, int]]):
        self.views: dict[tuple, View] = {}
        self.receivers: list[tuple[View, str]] = []  # (view, filter) of each client
        for client in config["clients"]:
            palette = client["palette"] or config["palette"]
            key = (client["width"], client["height"], client["mode"], palette)
            view = self.views.get(key)
            if view is None:
                mode = load_mode(client["mode"])
                maps = grid.receiver_maps(sizes, client["width"], client["height"],
                                          mode.ROWS_PER_CELL, config["padding"])
                view = self.views[key] = View(key, mode, palette, *maps)
            self.receivers.append((view, client["filter"]))

    def pixels(self, view: View, sources: list[np.ndarray]) -> np.ndarray:
        """The view's output pixels, uint8 [pixel rows, cells, 3]."""
        out = np.zeros((*view.src.shape, 3), np.uint8)
        for i, frame in enumerate(sources):
            at = view.src == i
            out[at] = frame[view.sy[at], view.sx[at]]
        return out

    def frames(self, sources: list[np.ndarray]) -> list[bytes]:
        """uint8 [H, W, 3] of each source -> each receiver's frame."""
        composites: dict[tuple, np.ndarray] = {}
        done: dict[tuple, bytes] = {}
        out = []
        for view, name in self.receivers:
            key = (view.key, name)
            if key not in done:
                if view.key not in composites:
                    composites[view.key] = self.pixels(view, sources)
                body = view.mode.render(filters.apply(composites[view.key], name), view.palette)
                done[key] = geometry.pad(body, view.pad_w, view.pad_h)
            out.append(done[key])
        return out
