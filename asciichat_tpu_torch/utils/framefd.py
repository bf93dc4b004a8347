"""ANSI frame reader/writer over file descriptors.

Parity with lib/terminal/fd/{reader,writer}.c: frames travel over a pipe/fd
as a tiny length-prefixed envelope of per-row records. The row framing lets
a consumer validate/display row-by-row as it parses; transport is
whole-envelope (one write per frame — same as the reference's writer, which
buffers the full frame before the fd write). Format per frame:
  b"ACFD" | u32 total_len | u32 rows | rows x (u32 line_len | line bytes)
"""

from __future__ import annotations

import struct

MAGIC = b"ACFD"


def write_frame(fd_write, frame: bytes) -> None:
    lines = frame.split(b"\n")
    body = b"".join(struct.pack(">I", len(ln)) + ln for ln in lines)
    fd_write(MAGIC + struct.pack(">II", len(body), len(lines)) + body)


def _read_exact(fd_read, n: int) -> bytes:
    """Accumulate exactly n bytes. POSIX reads on pipes/sockets return
    SHORT once payloads exceed the kernel buffer (~64 KiB pipes) — a single
    fd_read(total) misdiagnosed every large healthy frame as 'truncated'."""
    chunks = []
    got = 0
    while got < n:
        chunk = fd_read(n - got)
        if not chunk:
            break  # real EOF mid-record: caller reports truncation
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(fd_read) -> bytes | None:
    """-> frame bytes, None at clean EOF, ValueError on truncation/corruption."""
    hdr = fd_read(12)
    if not hdr:
        return None  # clean EOF between frames
    if len(hdr) < 12:
        hdr += _read_exact(fd_read, 12 - len(hdr))  # short header read
    if len(hdr) < 12:
        raise ValueError(f"truncated frame header ({len(hdr)} of 12 bytes)")
    if hdr[:4] != MAGIC:
        raise ValueError("bad frame-fd magic")
    total, rows = struct.unpack(">II", hdr[4:])
    body = _read_exact(fd_read, total)
    if len(body) < total:
        raise ValueError(f"truncated frame body ({len(body)} of {total} bytes)")
    lines = []
    off = 0
    for _ in range(rows):
        if off + 4 > total:
            raise ValueError("corrupt frame: row header past body end")
        (n,) = struct.unpack(">I", body[off : off + 4])
        off += 4
        if off + n > total:
            raise ValueError("corrupt frame: row length past body end")
        lines.append(body[off : off + n])
        off += n
    if off != total:
        # rows consumed less than total_len declared: surface the desync AT
        # the corrupt frame, not one frame later as a confusing bad-magic
        raise ValueError(
            f"corrupt frame: {total - off} trailing bytes after {rows} rows")
    return b"\n".join(lines)
