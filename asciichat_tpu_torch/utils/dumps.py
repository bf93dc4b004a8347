"""Ambient crash/hang dump channel for every asciichat process.

The reference's `ascii-query-server` attaches LLDB to a RUNNING process
(src/tooling/query/main.cpp:1-60) — no cooperation needed. This
environment has no debugger (no gdb/lldb/py-spy), so the equivalent is
split in two:

- every asciichat process registers a SIGUSR1 -> faulthandler dump into a
  well-known per-pid file at startup (this module). faulthandler writes at
  the C signal-handler level WITHOUT taking the GIL, so the dump works even
  when every Python thread is deadlocked on locks — precisely the hung
  process the tool exists for. This is ambient (all modes, no flag), so a
  process never needs to have been started with `--inspect-port` to be
  inspectable.
- `apps/query.py` attaches from outside: kernel-side state from /proc
  (works on ANY pid, zero cooperation) plus the SIGUSR1-triggered Python
  stacks, served over HTTP.

The port's copy of ``asciichat_tpu/utils/dumps.py``, with one addition:
once the handler is registered, the channel appends :func:`registered_line`
to the file, so that ``apps/query.py`` can tell a registered channel from a
file left by a registration that failed, where /proc does not say whether
the process catches SIGUSR1.
"""

from __future__ import annotations

import contextlib
import os
import tempfile


def dump_path(pid: int | None = None) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"asciichat-dump-{pid or os.getpid()}.txt")


def registered_line(pid: int | None = None) -> str:
    """The line a process appends to its dump file once its SIGUSR1 handler
    is registered."""
    return f"asciichat dump channel registered by pid {pid or os.getpid()}\n"


def install_dump_handlers():
    """SIGUSR1 -> all-thread stack dump appended to dump_path(). Returns the
    kept-open file (faulthandler holds the fd) or None where unsupported."""
    import faulthandler
    import signal
    import stat

    try:
        # The path is predictable and lives in a world-writable directory, so
        # open it symlink-safely and refuse anything another user pre-created:
        # O_NOFOLLOW stops symlink redirection, 0600 keeps stacks private,
        # and the fstat check rejects a same-name regular file planted by a
        # different uid (which O_CREAT would happily append to).
        flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
        flags |= getattr(os, "O_NOFOLLOW", 0)
        fd = os.open(dump_path(), flags, 0o600)
        st = os.fstat(fd)
        if st.st_uid != os.getuid() or not stat.S_ISREG(st.st_mode):
            os.close(fd)
            return None  # foreign/planted file: no dump channel
        # the 0o600 mode only applies at CREATION: a pre-existing same-uid
        # file with a permissive mode (old version + default umask) would
        # keep receiving private thread stacks world-readable
        with contextlib.suppress(OSError):
            os.fchmod(fd, 0o600)
        f = os.fdopen(fd, "a")
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True,
                              chain=False)
        f.write(registered_line())
        f.flush()
        return f
    except (OSError, AttributeError, ValueError):
        return None  # non-POSIX or sandboxed tmp: dumps unavailable
