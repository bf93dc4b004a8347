"""The session framework's display and pacing, as mirror mode uses them.

Copied from ``asciichat_tpu/models/session.py`` (src/common/session/
display.c in the reference):

- DisplaySink: terminal frame writing with first-frame reset, chat lines,
  help/fps overlays (display.c + client display semantics).
- Pacer: fps-cap pacing shared by thread loops and asyncio tasks.

The capture-side ``FrameTransform`` is the port's own
(``models/mirror.py``); the reconnect policy waits for the client.
"""

from __future__ import annotations

from asciichat_tpu_torch.utils import term, ui
from asciichat_tpu_torch.utils.fps import FpsCounter


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
