"""Shared session framework: the capture/display/retry layer of the mirror
and the client.

Copied from ``asciichat_tpu/models/session.py`` (src/common/session/ in the
reference: client_like.c, pipeline.c, display.c):

- FrameTransform: the capture-side frame chain (flip, digital rain overlay,
  color filter, upload fit) with its live-mutable fields, used by the
  mirror's convert stage and the client's capture task (pipeline.c stage
  1->2).
- DisplaySink: terminal frame writing with first-frame reset, chat lines,
  help/fps overlays (display.c + client display semantics).
- DisplayThread (the port's own): a DisplaySink driven from a thread of its
  own, so that a terminal write that blocks (a stdout pipe whose reader
  lags) never stalls the client's event loop, and with it its audio.
- ReconnectPolicy: the reference's backoff-with-reset connect retry
  (client_like.c reconnect loop).
- Pacer: fps-cap pacing shared by thread loops and asyncio tasks.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Callable

import numpy as np
import torch

from asciichat_tpu_torch.ops import filters
from asciichat_tpu_torch.ops.rain import DigitalRain
from asciichat_tpu_torch.runtime.device import default_device
from asciichat_tpu_torch.runtime.double_buffer import LatestFrame
from asciichat_tpu_torch.utils import term, ui
from asciichat_tpu_torch.utils.fps import FpsCounter
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("display")


class FrameTransform:
    """Capture-side frame chain (pipeline.c capture->convert hand-off):
    flips -> digital-rain overlay -> color filter -> optional upload fit (the
    oracle's resize, so an uploaded picture is the one the reference client
    sends). All fields are live-mutable (keybindings toggle them
    mid-session). The rain runs on ``device`` (``default_device()`` when
    None, resolved at the first frame that asks for rain) and its frame
    stays there unless a later step works on the host."""

    def __init__(self, flip_x: bool = False, flip_y: bool = False,
                 matrix: bool = False, color_filter: str = "none",
                 max_upload: tuple[int, int] | None = None,
                 device: torch.device | str | None = None):
        self.flip_x = flip_x
        self.flip_y = flip_y
        self.matrix = matrix
        self.color_filter = color_filter
        self.max_upload = max_upload
        self.device = None if device is None else torch.device(device)
        self._rain: DigitalRain | None = None
        self._t0 = time.monotonic()

    def _overlay(self, frame: np.ndarray) -> torch.Tensor:
        h, w = frame.shape[:2]
        rain = self._rain
        if rain is None or rain.num_columns != w or rain.num_rows != h:
            # both dimensions: a height-only change (a file source switching
            # clips) with a stale num_rows would not match the frame
            if self.device is None:
                self.device = default_device()
            rain = self._rain = DigitalRain(w, h, device=self.device)
        on_device = torch.from_numpy(np.ascontiguousarray(frame)).to(rain.device)
        return rain.apply(on_device, time.monotonic() - self._t0)

    def __call__(self, frame: np.ndarray) -> np.ndarray | torch.Tensor:
        frame = np.asarray(frame)
        if self.flip_x:
            frame = frame[:, ::-1]
        if self.flip_y:
            frame = frame[::-1]
        if self.matrix:
            frame = self._overlay(frame)
            if self.color_filter == "none" and self.max_upload is None:
                return frame
            frame = frame.cpu().numpy()
        if self.color_filter != "none":
            frame = filters.apply_color_filter_reference(
                frame, self.color_filter, time.monotonic())
        if self.max_upload is not None:
            mw, mh = self.max_upload
            h, w = frame.shape[:2]
            if w > mw or h > mh:
                from asciichat_tpu_torch.render.oracle import resize_image
                from asciichat_tpu_torch.utils.aspect import fit_dimensions_pixel

                nw, nh = fit_dimensions_pixel(w, h, mw, mh)
                frame = resize_image(frame, nw, nh)
        return frame


class DisplaySink:
    """Terminal display with first-frame reset, overlays, and chat lines
    (src/common/session/display.c + src/client/display.c semantics)."""

    def __init__(self, stream=None, show_fps: bool = False):
        self.writer = term.FrameWriter(stream)
        self.show_fps = show_fps
        self.show_help = False
        self.fps = FpsCounter()
        self.frames_written = 0
        self._meta: tuple[str, tuple[int, int]] = ("", (0, 0))

    def setup(self) -> None:
        self.writer.setup()

    def teardown(self) -> None:
        self.writer.teardown()

    def set_meta(self, renderer_key: str, size: tuple[int, int]) -> None:
        self._meta = (renderer_key, size)

    def reset(self) -> None:
        """Force a full clear before the next frame (CLEAR_CONSOLE)."""
        self.writer._first = True

    def write_frame(self, frame: bytes) -> None:
        out = bytes(frame)
        if self.show_help:
            out += b"\x1b[0m\n" + ui.help_overlay()
        if self.show_fps:
            out += b"\x1b[0m\n" + ui.status_line(
                self.fps.fps, self.fps.frames, self._meta[0], self._meta[1])
        self.writer.write_frame(out)
        self.fps.tick()
        self.frames_written += 1

    def chat_line(self, text: bytes) -> None:
        """Inline chat below the frame (client text chat). SANITIZED: the
        bytes come from a relayed peer — raw control characters would let
        any chat participant inject ANSI/OSC escapes into every viewer's
        terminal (title spoofing, cursor games, emulator escape-handling
        bugs). Filtering must happen at the CODEPOINT level: a byte-level
        `b >= 0x80` allowlist passed C1 controls (raw 0x80-0x9F AND the
        UTF-8-encoded U+009B CSI, b'\\xc2\\x9b'), which terminals honoring
        8-bit controls execute exactly like ESC[. Printable text only;
        everything else becomes '?'."""
        s = text[:200].decode("utf-8", errors="replace")
        clean = "".join(
            ch if ch.isprintable() else "?" for ch in s
        ).encode("utf-8")
        self.writer.stream.write(b"\x1b[0m\r\n> " + clean + b"\r\n")
        self.writer.stream.flush()


class DisplayThread:
    """A DisplaySink written from a thread of its own (the reference runs
    its display, capture and playback on threads of their own,
    src/client/audio.c:276,531).

    Frames go through a ``LatestFrame``: a reader that lags makes the
    thread skip stale frames, as the reference's display does
    (video_frame.c:214-264), and never queues them. Every other operation
    (reset, chat line, overlay toggle, set_meta, setup, teardown) runs on
    the thread in the order it was posted, after the latest frame committed
    before it, so a reset never overtakes the frame before it. ``stop``
    writes the last committed frame, runs teardown and joins the thread
    within a limit: a stream that never drains cannot hold up the caller's
    exit."""

    MAX_CHAT = 64  # chat lines that may wait behind a blocked stream; later ones are dropped

    def __init__(self, sink: DisplaySink):
        self.sink = sink
        self.frames = LatestFrame()
        self._cond = threading.Condition()
        self._ops: collections.deque[tuple[int, Callable[[], None], bool]] = collections.deque()
        self._written = 0  # sequence of the last frame written
        self._stopping = False
        self.chat_dropped = 0
        self.write_failures = 0
        self._thread = threading.Thread(target=self._run, name="display", daemon=True)

    def start(self) -> None:
        self.call(self.sink.setup)
        self._thread.start()

    def commit(self, frame: bytes) -> None:
        """Make ``frame`` the next one to write (a frame not yet written is
        replaced). Never blocks on the stream."""
        with self._cond:
            self.frames.commit(frame)
            self._cond.notify()

    def call(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the thread, after the frames committed before."""
        self._post(functools.partial(fn, *args), chat=False)

    def chat_line(self, text: bytes) -> None:
        self._post(functools.partial(self.sink.chat_line, text), chat=True)

    def _post(self, op: Callable[[], None], chat: bool) -> None:
        with self._cond:
            if chat and sum(c for _, _, c in self._ops) >= self.MAX_CHAT:
                self.chat_dropped += 1
                return
            self._ops.append((self.frames.latest()[1], op, chat))
            self._cond.notify()

    def stop(self, timeout: float) -> bool:
        """Write the last committed frame and what was posted, run
        teardown, and join; False (logged) when the thread is still blocked
        in a write after ``timeout`` seconds."""
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout)
        if self._thread.is_alive():
            log.warning("a terminal write is still blocked after %.1f s; leaving it behind",
                        timeout)
            return False
        return True

    def _run(self) -> None:
        while True:
            # the posted operations and the latest frame, taken together:
            # an operation posted after this frame's commit has seq >= its
            with self._cond:
                while (not self._ops and not self._stopping
                       and self.frames.latest()[1] == self._written):
                    self._cond.wait()
                ops = list(self._ops)
                self._ops.clear()
                frame, seq, _ = self.frames.latest()
                stopping = self._stopping
            for posted, op, _chat in ops:
                if self._written < seq <= posted:
                    self._write(frame, seq)
                self._apply(op)
            if seq > self._written:
                self._write(frame, seq)
            if stopping:
                with self._cond:
                    if not self._ops and self.frames.latest()[1] == self._written:
                        break
        self._apply(self.sink.teardown)

    def _write(self, frame: bytes, seq: int) -> None:
        self._written = seq
        self._apply(functools.partial(self.sink.write_frame, frame))

    def _apply(self, op: Callable[[], None]) -> None:
        try:
            op()
        except (OSError, ValueError) as e:  # a closed or broken stream
            self.write_failures += 1
            if self.write_failures == 1:
                log.warning("terminal write failed (%s)", e)


class ReconnectPolicy:
    """Backoff-with-reset retry schedule (client_like.c reconnect loop)."""

    SCHEDULE = (0.5, 1.0, 2.0, 5.0)

    def __init__(self, enabled: bool = True, schedule: tuple[float, ...] = SCHEDULE):
        self.enabled = enabled
        self.schedule = schedule
        self._it = iter(schedule)

    def next_delay(self) -> float:
        return next(self._it, self.schedule[-1])

    def reset(self) -> None:
        self._it = iter(self.schedule)


class Pacer:
    """fps-cap pacing usable from thread loops and asyncio tasks alike:
    sleep_for(t0) returns how long to wait to hold the cadence."""

    def __init__(self, fps: float):
        self.interval = 1.0 / fps if fps else 0.0
        self._last = 0.0

    def sleep_for(self, t0: float, now: float) -> float:
        return max(0.0, self.interval - (now - t0))

    def should_drop(self, now: float) -> bool:
        """Display-side cap: drop frames arriving faster than the cadence
        (the mirror render loop's stay-at-cap rule)."""
        if now - self._last < self.interval:
            return True
        self._last = now
        return False
