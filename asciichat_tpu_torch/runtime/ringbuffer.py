"""Lock-free SPSC audio ring buffer (native) — lib/ringbuffer.c parity.

Producer (network receive) and consumer (mixer tick) touch atomics only.
On overflow the ring itself drops the NEWEST samples (the write is
truncated, counted in `overruns`) — an SPSC ring cannot advance the tail
from the producer side without breaking the single-consumer invariant.
Latest-audio-wins latency bounding therefore lives at the CONSUMER: the
server's audio tick sheds backlog past its maximum before reading
(apps/server._audio_tick), exactly like the reference's consumer-side
drop (lib/ringbuffer.c role).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib():
    from asciichat_tpu_torch.runtime.kernel_build import native_lib

    lib = native_lib("ringbuffer")
    lib.ac_ring_create.argtypes = [ctypes.c_uint64]
    lib.ac_ring_create.restype = ctypes.c_void_p
    lib.ac_ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("ac_ring_size", "ac_ring_capacity", "ac_ring_overruns"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_uint64
    fp = ctypes.POINTER(ctypes.c_float)
    lib.ac_ring_write.argtypes = [ctypes.c_void_p, fp, ctypes.c_uint64]
    lib.ac_ring_write.restype = ctypes.c_uint64
    lib.ac_ring_read.argtypes = [ctypes.c_void_p, fp, ctypes.c_uint64]
    lib.ac_ring_read.restype = ctypes.c_uint64
    return lib


class AudioRing:
    def __init__(self, capacity: int = 48000):
        self._lib = _lib()
        self._ring = self._lib.ac_ring_create(capacity)
        if not self._ring:
            # a NULL handle would be dereferenced inside the next C call
            raise MemoryError("ac_ring_create failed (allocation)")

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.ac_ring_destroy(self._ring)
            self._ring = None

    def __len__(self) -> int:
        return int(self._lib.ac_ring_size(self._ring))

    @property
    def capacity(self) -> int:
        return int(self._lib.ac_ring_capacity(self._ring))

    @property
    def overruns(self) -> int:
        return int(self._lib.ac_ring_overruns(self._ring))

    def write(self, samples: np.ndarray) -> int:
        # ravel + .size: len() of a 2-D array is its first dimension, which
        # would silently drop every sample past the first row
        buf = np.ascontiguousarray(samples, dtype=np.float32).ravel()
        return int(self._lib.ac_ring_write(
            self._ring, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            buf.size
        ))

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = int(self._lib.ac_ring_read(
            self._ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
        ))
        return out[:got]
