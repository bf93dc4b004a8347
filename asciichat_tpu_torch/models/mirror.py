"""Mirror mode: local capture -> ASCII -> terminal, no network.

Counterpart of ``asciichat_tpu/models/mirror.py`` on the port's renderer.
Capture runs on a thread feeding a drop-on-full queue; the main loop converts
on the renderer's device and writes frames. ``--snapshot`` renders one frame
and exits (session/render.c:128-143). Display and pacing are the session
framework's (``models/session.py``), and so is the capture-side
``FrameTransform``, which the client shares.
"""

from __future__ import annotations

import queue
import threading
import time

import torch

from asciichat_tpu_torch.models.session import DisplaySink, FrameTransform, Pacer
from asciichat_tpu_torch.render.pipeline import AsciiRenderer
from asciichat_tpu_torch.render.types import TerminalCapabilities
from asciichat_tpu_torch.runtime.double_buffer import FrameQueue
from asciichat_tpu_torch.runtime.framesource import FrameSource
from asciichat_tpu_torch.utils import ui
from asciichat_tpu_torch.utils.errors import AsciiChatError, ErrorCode
from asciichat_tpu_torch.utils.keyboard import KeyboardReader


class MirrorSession:
    def __init__(
        self,
        source: FrameSource,
        caps: TerminalCapabilities,
        width: int,
        height: int,
        palette: str,
        fps_limit: float = 60.0,
        color_filter: str = "none",
        flip_x: bool = False,
        flip_y: bool = False,
        stretch: bool = False,
        show_fps: bool = False,
        matrix: bool = False,
        device: torch.device | str | None = None,
    ):
        self.source = source
        self.caps = caps
        self.width = width
        self.height = height
        self.renderer = AsciiRenderer(palette, device)
        self.transform = FrameTransform(flip_x=flip_x, flip_y=flip_y, matrix=matrix,
                                        color_filter=color_filter,
                                        device=self.renderer.device)
        self.stretch = stretch
        self.display = DisplaySink(show_fps=show_fps)
        self.display.set_meta(caps.renderer_key(), (width, height))
        self.pacer = Pacer(fps_limit)
        self.queue = FrameQueue(maxsize=2)
        self._stop = threading.Event()
        self._filter_cycle = ["none", "green", "cyan", "orange", "rainbow"]

    # the transform's live fields (keybindings and tests mutate these)
    @property
    def flip_x(self):
        return self.transform.flip_x

    @flip_x.setter
    def flip_x(self, v):
        self.transform.flip_x = v

    @property
    def matrix(self):
        return self.transform.matrix

    @matrix.setter
    def matrix(self, v):
        self.transform.matrix = v

    @property
    def color_filter(self):
        return self.transform.color_filter

    @color_filter.setter
    def color_filter(self, v):
        self.transform.color_filter = v

    @property
    def writer(self):
        return self.display.writer

    def _on_key(self, key: str) -> None:
        """Live keybindings (session keyboard_handler.c analog)."""
        if key in ("q", "\x03"):
            self._stop.set()
        elif key == "f":
            self.flip_x = not self.flip_x
        elif key == "m":
            self.matrix = not self.matrix
        elif key == "c":
            cyc = self._filter_cycle
            cur = self.color_filter
            i = cyc.index(cur) + 1 if cur in cyc else 0
            self.color_filter = cyc[i % len(cyc)]
        elif key == "?":
            self.display.show_help = not self.display.show_help

    def _capture_thread(self) -> None:
        interval = 1.0 / getattr(self.source, "fps", 30.0)
        while not self._stop.is_set():
            t0 = time.monotonic()
            frame = self.source.read()
            if frame is None:
                self.queue.push(None)
                return
            self.queue.push(frame)
            dt = time.monotonic() - t0
            if dt < interval:
                time.sleep(interval - dt)

    def _convert(self, frame) -> bytes:
        return self.renderer.convert(
            self.transform(frame), self.width, self.height, self.caps,
            stretch=self.stretch,
        )

    def run_snapshot(self) -> bytes:
        frame = self.source.read()
        if frame is None:
            raise AsciiChatError(ErrorCode.MEDIA,
                                 "no frame available from the media source")
        out = self._convert(frame)
        self.display.writer.write_frame(out)
        return out

    def run(self, max_frames: int | None = None) -> int:
        cap = threading.Thread(target=self._capture_thread, daemon=True)
        cap.start()
        keyboard = KeyboardReader(self._on_key)
        keyboard.start()
        self.display.setup()
        if self.display.writer.is_tty:
            # animated banner reveal before the stream (lib/ui/splash.c)
            for frame in ui.splash_frames(self.width):
                self.display.writer.write_frame(frame)
                time.sleep(0.04)
            self.display.reset()
        rendered = 0
        try:
            while not self._stop.is_set():
                try:
                    frame = self.queue.pop(timeout=1.0)
                except queue.Empty:
                    continue
                if frame is None:
                    break
                if self.pacer.should_drop(time.monotonic()):
                    continue  # drop: stay at the fps cap
                self.display.write_frame(self._convert(frame))
                rendered += 1
                if max_frames and rendered >= max_frames:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            self._stop.set()
            keyboard.stop()
            self.display.teardown()
            self.source.close()
        return rendered
