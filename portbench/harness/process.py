"""The caller's process as its configuration states it (``process``).

``environment`` sets variables before the program is imported (the emitter
reads ASCIICHAT_EMIT_THREADS at import); ``mallopt`` sets glibc's allocator
options by name. A converter that keeps its heap and a few emitter threads
on a host whose cores it shares is a deployment choice, stated in the file
beside the terminal and the mode, and applied before anything is timed.
"""

from __future__ import annotations

import ctypes
import os

# glibc malloc.h
MALLOPT = {"M_TRIM_THRESHOLD": -1, "M_TOP_PAD": -2, "M_MMAP_THRESHOLD": -3,
           "M_MMAP_MAX": -4, "M_ARENA_MAX": -8}


def apply(conf: dict) -> list[str]:
    """Applies ``conf["process"]``; returns what it set, one line each."""
    proc = conf.get("process", {})
    done = []
    for key, value in proc.get("environment", {}).items():
        os.environ[key] = str(value)
        done.append(f"{key}={value}")
    options = proc.get("mallopt", {})
    if options:
        libc = ctypes.CDLL(None)
        for name, value in options.items():
            if libc.mallopt(MALLOPT[name], int(value)) != 1:
                raise OSError(f"mallopt({name}, {value}) refused")
            done.append(f"mallopt {name}={value}")
    return done
