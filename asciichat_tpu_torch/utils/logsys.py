"""Logging system: leveled, rotating, grep-filterable.

Maps the reference's log stack (lib/log/, SURVEY §2c): levels DEV..FATAL
(log.h:59-62), 3 MB file rotation (log.h:67), terminal colorization, JSON
sink (lib/log/json.c), regex --grep filtering applied at init
(lib/log/grep.c, src/main.c:522-535), and rate-limited log_debug_every.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import re
import sys
import time

DEV = 5  # below DEBUG, like the reference's LOG_DEV
logging.addLevelName(DEV, "DEV")

ROTATE_BYTES = 3 * 1024 * 1024  # log.h:67
_COLORS = {
    "DEV": "\x1b[90m", "DEBUG": "\x1b[36m", "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m", "ERROR": "\x1b[31m", "CRITICAL": "\x1b[35m",
}


class GrepFilter(logging.Filter):
    """PCRE-style include filter (lib/log/grep.c analog)."""

    def __init__(self, pattern: str):
        super().__init__()
        self.rx = re.compile(pattern)

    def filter(self, record: logging.LogRecord) -> bool:
        return bool(self.rx.search(record.getMessage()))


class ColorFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"{color}{base}\x1b[0m"
        return base


class JsonFormatter(logging.Formatter):
    def format(self, record):
        entry = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            # log.exception() tracebacks must survive --log-json, or
            # crashes in JSON-logged deployments are undiagnosable
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


class RingLogHandler(logging.Handler):
    """In-memory ring of recent records with regex search (the reference's
    named ring-buffer logs + search, lib/log/{named,search}.c, mmap ring)."""

    def __init__(self, capacity: int = 2048):
        super().__init__()
        from collections import deque

        self.ring = deque(maxlen=capacity)

    def emit(self, record):
        try:
            self.ring.append((record.created, record.levelname, record.name,
                              record.getMessage()))
        except Exception:
            pass

    def search(self, pattern: str, limit: int = 100) -> list[tuple]:
        rx = re.compile(pattern)
        return [e for e in self.ring if rx.search(e[3])][-limit:]

    def tail(self, n: int = 50) -> list[tuple]:
        return list(self.ring)[-n:]


ring_log = RingLogHandler()

_configured = False


def configure(
    level: str = "INFO",
    log_file: str | None = None,
    grep: str | None = None,
    json_output: bool = False,
) -> None:
    global _configured
    root = logging.getLogger("asciichat")
    root.handlers.clear()
    # the asciichat tree owns its sinks: without this, a host process with
    # root-logger handlers (logging.basicConfig anywhere) double-emits
    # every record with unrelated formatting
    root.propagate = False
    root.setLevel(DEV if level.upper() == "DEV" else level.upper())
    fmt = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(JsonFormatter() if json_output else ColorFormatter(fmt))
    root.addHandler(stream)
    # ring_log is a module singleton surviving reconfigures: reset its
    # filters or grep patterns from prior configure() calls AND together
    # forever (the inspector/status screen would silently show only lines
    # matching every historical grep)
    ring_log.filters.clear()
    root.addHandler(ring_log)  # always-on in-memory ring for search/inspector
    if log_file:
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=ROTATE_BYTES, backupCount=3
        )
        fh.setFormatter(logging.Formatter(fmt))
        root.addHandler(fh)
    if grep:
        for h in root.handlers:
            h.addFilter(GrepFilter(grep))
    _configured = True


def get_logger(name: str) -> logging.Logger:
    if not _configured:
        configure()
    return logging.getLogger(f"asciichat.{name}")


class RateLimited:
    """log_debug_every analog: emit at most once per interval."""

    def __init__(self, interval_s: float):
        self.interval = interval_s
        self._last: dict[str, float] = {}

    def should_log(self, key: str) -> bool:
        now = time.monotonic()
        if now - self._last.get(key, 0.0) >= self.interval:
            self._last[key] = now
            return True
        return False


class MmapRingLog:
    """Crash-persistent mmap-backed ring log (lib/log/mmap.c:34-44 analog):
    records survive process death because the OS flushes the mapping; the
    panic path and post-mortem tooling read them back without the process.

    Layout: 16-byte header (magic u32, capacity u32, write_off u64) followed
    by capacity bytes of newline-separated records, wrapped."""

    MAGIC = 0xA5C11106
    HDR = 16

    def __init__(self, path: str, capacity: int = 256 * 1024):
        import mmap as mmap_mod
        import os as os_mod
        import struct as struct_mod

        self._struct = struct_mod
        size = self.HDR + capacity
        new = not os_mod.path.exists(path) or os_mod.path.getsize(path) != size
        self._f = open(path, "w+b" if new else "r+b")
        if new:
            self._f.truncate(size)
        self._mm = mmap_mod.mmap(self._f.fileno(), size)
        magic, cap, _off = struct_mod.unpack_from("<IIQ", self._mm, 0)
        if magic != self.MAGIC or cap != capacity:
            struct_mod.pack_into("<IIQ", self._mm, 0, self.MAGIC, capacity, 0)
            self._mm[self.HDR:] = b"\0" * capacity
        self.capacity = capacity

    def append(self, line: str) -> None:
        data = (line.rstrip("\n") + "\n").encode(errors="replace")
        if len(data) > self.capacity:
            data = data[-self.capacity:]
        _, _, off = self._struct.unpack_from("<IIQ", self._mm, 0)
        start = off % self.capacity
        first = min(len(data), self.capacity - start)
        self._mm[self.HDR + start : self.HDR + start + first] = data[:first]
        if first < len(data):  # wrap: at most two slice writes
            self._mm[self.HDR : self.HDR + len(data) - first] = data[first:]
        off += len(data)
        self._struct.pack_into("<IIQ", self._mm, 0, self.MAGIC, self.capacity, off)

    def tail(self, max_bytes: int = 65536) -> list[str]:
        """Most recent records (readable even from a different process after
        a crash — open the same path)."""
        _, cap, off = self._struct.unpack_from("<IIQ", self._mm, 0)
        n = min(off, cap, max_bytes)
        start = (off - n) % cap
        first = min(n, cap - start)
        out = bytes(self._mm[self.HDR + start : self.HDR + start + first])
        if first < n:
            out += bytes(self._mm[self.HDR : self.HDR + n - first])
        text = out.decode(errors="replace")
        lines = [ln for ln in text.split("\n") if ln]
        # The first record is a partial whenever the read did not start at
        # the true beginning of the stream (ring wrap or a max_bytes window
        # cutting mid-record — both are off > n) UNLESS the cut landed on a
        # record boundary. Boundary evidence: the window starts with the
        # previous record's '\n' terminator, or the byte logically BEFORE
        # the window (still in the ring iff n < cap) is that terminator.
        if off > n and lines:
            boundary = text.startswith("\n")
            if not boundary and n < cap:
                prev_idx = (off - n - 1) % cap
                boundary = self._mm[self.HDR + prev_idx] == 0x0A
            if not boundary:
                lines = lines[1:]
        return lines

    def close(self) -> None:
        self._mm.flush()
        self._mm.close()
        self._f.close()


class MmapLogHandler(logging.Handler):
    """Bridge: logging records into an MmapRingLog."""

    def __init__(self, path: str, capacity: int = 256 * 1024):
        super().__init__()
        self.ring = MmapRingLog(path, capacity)

    def emit(self, record):
        try:
            self.ring.append(
                f"{record.created:.3f} {record.levelname} "
                f"{record.name}: {record.getMessage()}"
            )
        except Exception:
            pass
