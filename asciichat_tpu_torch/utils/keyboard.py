"""Raw-mode keyboard input (platform keyboard + session keyboard_handler).

Parity with lib/platform/ keyboard handling + src/common/session/
keyboard_handler.c: a reader thread in cbreak mode delivers single
keypresses; sessions bind them to live actions (quit, flip, filter cycling,
help overlay). Degrades to a no-op when stdin is not a TTY (piped runs).
"""

from __future__ import annotations

import os
import select
import sys
import threading


class KeyboardReader:
    def __init__(self, on_key):
        self.on_key = on_key
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._saved = None
        self.enabled = sys.stdin.isatty()

    def start(self) -> None:
        if not self.enabled:
            return
        if sys.platform == "win32":  # pragma: no cover - Windows console
            # Win32 console path (lib/platform/windows/ keyboard role):
            # raw per-key mode via kernel32, reads via msvcrt.getwch —
            # select() does not work on console handles
            from asciichat_tpu_torch.utils import platform_win

            try:
                ctx = platform_win.raw_keyboard()
                ctx.__enter__()
            except OSError:
                # TTY-like stdin that is not a real console (mintty/MSYS
                # pty): degrade to no keyboard, never crash the session
                self.enabled = False
                return
            self._raw_ctx = ctx
            self._thread = threading.Thread(target=self._loop_win, daemon=True)
            self._thread.start()
            return
        import termios
        import tty

        fd = sys.stdin.fileno()
        try:
            self._saved = termios.tcgetattr(fd)
            tty.setcbreak(fd)
        except (termios.error, OSError):
            # tty-like fd without termios support (or a background process
            # denied tcsetattr): the docstring's promise is degrade, not
            # crash — same contract as the win32 branch
            self._saved = None
            self.enabled = False
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        import codecs

        fd = sys.stdin.fileno()
        # incremental decode: a multibyte keypress ('é') must arrive as ONE
        # key, not two U+FFFD halves that can never match a binding
        dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
        while not self._stop.is_set():
            r, _, _ = select.select([fd], [], [], 0.1)
            if not r:
                continue
            try:
                raw = os.read(fd, 64)
            except OSError:
                return
            if not raw:
                # EOF (hangup / pty master closed): select() stays readable
                # forever — looping on empty reads pegged the CPU core
                return
            text = dec.decode(raw)
            i = 0
            while i < len(text):
                ch = text[i]
                if ch == "\x1b":
                    # swallow escape sequences (CSI/SS3 arrows, mouse
                    # reports): emitting their bytes as individual keys
                    # misfired letter bindings on sequence finals
                    j = i + 1
                    if j < len(text) and text[j] in "[O":
                        j += 1
                        while j < len(text) and not ("@" <= text[j] <= "~"):
                            j += 1
                        i = j + 1  # skip the final too (may be len: done)
                        continue
                    if j >= len(text):
                        # lone ESC at buffer end: deliver it (quit-style
                        # bindings); a real sequence arrives in one read
                        # from any terminal
                        self.on_key(ch)
                        i = j
                        continue
                    i = j
                    continue
                self.on_key(ch)
                i += 1

    def _loop_win(self) -> None:  # pragma: no cover - Windows console
        import msvcrt  # type: ignore[import-not-found]

        while not self._stop.is_set():
            if msvcrt.kbhit():
                try:
                    self.on_key(msvcrt.getwch())
                except OSError:
                    return
            else:
                self._stop.wait(0.05)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=0.5)
        if getattr(self, "_raw_ctx", None) is not None:  # pragma: no cover
            self._raw_ctx.__exit__(None, None, None)
            self._raw_ctx = None
        if self._saved is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, self._saved)
