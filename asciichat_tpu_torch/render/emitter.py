"""Host-side ANSI emission from device cell records (native C++ fast path).

Bridges asciichat_tpu_torch.ops.cells record dicts to the multithreaded C++ emitter
(native/emitter.cpp). The byte grammar it produces is the reference's scalar
renderer grammar (SURVEY.md A.2); golden-tested against render/oracle.py.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.runtime.kernel_build import emitter_lib

def _default_threads() -> int:
    """Emitter worker threads: ASCIICHAT_EMIT_THREADS pins the count (the
    serving-path flag — the reference parallelizes per-client render threads,
    src/server/render.c:340; here threads split the frame batch), else one
    per core capped at 16. Byte output is thread-count-invariant
    (tests/test_golden_render.py::test_emit_multithreaded_byte_identical)."""
    env = os.environ.get("ASCIICHAT_EMIT_THREADS", "")
    if env.isdigit() and int(env) > 0:
        return min(64, int(env))
    return max(1, min(16, (os.cpu_count() or 4)))


_DEFAULT_THREADS = _default_threads()

# Reusable per-thread output buffers: allocating a fresh multi-MB np.empty
# every call page-faults the whole buffer each tick (~50% of emit time at
# 203x64x32); buffers are keyed by rounded-up size class and reused.
_tls = threading.local()


def _out_buffers(b: int, stride: int) -> tuple[np.ndarray, np.ndarray, int]:
    """-> (out, lens, stride_class). The buffer row length is the stride
    ROUNDED UP to a 16 KiB class (passed to the native emitter as its frame
    stride), so terminal-resize churn reuses one buffer instead of
    allocating — and page-faulting — a fresh multi-MB array per geometry.
    Eviction is FIFO per entry, never a clear() that also drops the hot
    serving-path buffer."""
    cls = max(16384, -(-stride // 16384) * 16384)
    cache = getattr(_tls, "bufs", None)
    if cache is None:
        cache = _tls.bufs = {}
    key = (b, cls)
    got = cache.get(key)
    if got is None:
        while len(cache) > 8:
            cache.pop(next(iter(cache)))
        got = cache[key] = (np.empty((b, cls), np.uint8), np.zeros(b, np.int64))
    return got[0], got[1], cls


# per-table caches: a 65-255 char palette is VALID for the truecolor/256
# paths (parse clips at 255 like the reference), and eagerly building the
# 64-ramp mono table for those modes raised ValueError before any frame
# rendered — each mode now builds only the tables it indexes
@functools.lru_cache(maxsize=64)
def _table_mono(palette: str) -> np.ndarray:
    return np.ascontiguousarray(pal.mono_glyph_table(palette), dtype=np.uint8)


@functools.lru_cache(maxsize=64)
def _table_luma(palette: str) -> np.ndarray:
    return np.ascontiguousarray(pal.luminance_glyph_table(palette), dtype=np.uint8)


@functools.lru_cache(maxsize=64)
def _table_ramp(palette: str) -> np.ndarray:
    return np.ascontiguousarray(pal.char_index_ramp_array(palette), dtype=np.uint8)


# required record -> trailing dims beyond [B, H, W], per mode. Doubles as
# the set of known modes (validated up front).
_MODE_RECORDS: dict[str, dict[str, tuple[int, ...]]] = {
    "mono": {"key": ()},
    "truecolor_fg": {"rgb": (3,), "luma": ()},
    "256color": {"color": (), "luma": ()},
    "16color": {"color": (), "key": ()},
    "16color_dithered": {"rgb": (3,), "luma": ()},
    "16color_dithered_bg": {"rgb": (3,), "luma": ()},
    "halfblock_truecolor": {"top": (3,), "bot": (3,)},
    "halfblock_256": {"fg": (), "bg": (), "transparent": ()},
    "halfblock_16": {"fg": (), "bg": (), "transparent": ()},
    "halfblock_mono": {"top": (3,), "bot": (3,)},
}


def _validate_records(records, mode: str) -> tuple[int, int, int]:
    """Shape-check EVERY record the native emitter will index and return
    (b, h, w). This guard lives at the native boundary, not in one caller:
    deriving b/h/w from whichever array came first let an unbatched [H,W,3]
    frame (b=H, h=W, w=3) drive ac_emit_* into a 9x out-of-bounds read."""
    spec = _MODE_RECORDS.get(mode)
    if spec is None:
        raise ValueError(f"unknown mode {mode!r}")
    dims: tuple[int, int, int] | None = None
    for name, trailing in spec.items():
        arr = records.get(name)
        if arr is None:
            raise ValueError(f"mode {mode!r} requires record {name!r}")
        want_ndim = 3 + len(trailing)
        if arr.ndim != want_ndim or arr.shape[3:] != trailing:
            raise ValueError(
                f"record {name!r} for mode {mode!r} must be [B,H,W"
                + (",3]" if trailing else "]")
                + f"; got shape {arr.shape} (unbatched frame? add [None])")
        if dims is None:
            dims = arr.shape[:3]
        elif arr.shape[:3] != dims:
            raise ValueError(
                f"record {name!r} shape {arr.shape[:3]} disagrees with "
                f"{dims} — records must share [B,H,W]")
    return dims


def _worst_case_stride(mode: str, h: int, w: int, pad_w: int, pad_h: int) -> int:
    per_cell = {
        "mono": 4,
        "truecolor_fg": 23,  # 19-byte SGR + 4-byte glyph
        "256color": 15,
        "16color": 10,
        "16color_dithered": 10,
        "16color_dithered_bg": 16,
        "halfblock_truecolor": 41,  # fg(19)+bg(19)+glyph(3)
        "halfblock_256": 25,
        "halfblock_16": 15,
        "halfblock_mono": 7,
    }[mode]
    per_row = 8 + pad_w  # reset + newline + left padding
    # +8 slack for the emitter's 4-byte glyph over-copy and final reset
    return h * w * per_cell + h * per_row + pad_h + 8


def _u8(arr: np.ndarray) -> ctypes.POINTER(ctypes.c_uint8):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def emit_frames(
    records: dict[str, np.ndarray],
    mode: str,
    palette: str = pal.DEFAULT_PALETTE,
    pad_w: int = 0,
    pad_h: int = 0,
    nthreads: int | None = None,
    copy: bool = True,
) -> list[bytes]:
    """Emit a batch of byte-exact ANSI frames from host-side record arrays.

    copy=False returns zero-copy memoryviews into a per-thread buffer that is
    REUSED by the next emit_frames call on the same thread — consume (send/
    compress/compare) before emitting again. Materializing a 244 KB bytes
    object per frame costs ~95 us on this host, more than the emission itself;
    the serving path compresses/sends straight from the view instead.
    """
    lib = emitter_lib()
    nthreads = nthreads or _DEFAULT_THREADS

    b, h, w = _validate_records(records, mode)
    stride_min = _worst_case_stride(mode, h, w, pad_w, pad_h)
    out, lens, stride = _out_buffers(b, stride_min)
    lens_p = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    if mode == "mono":
        lib.ac_emit_mono(_u8(_c(records["key"])), b, h, w, _u8(_table_mono(palette)),
                         pad_w, pad_h, _u8(out), stride, lens_p, nthreads)
    elif mode == "truecolor_fg":
        lib.ac_emit_truecolor_fg(_u8(_c(records["rgb"])), _u8(_c(records["luma"])), b, h, w,
                                 _u8(_table_luma(palette)), pad_w, pad_h, _u8(out), stride, lens_p, nthreads)
    elif mode in ("256color", "16color"):
        gidx = records["luma"] if mode == "256color" else records["key"]
        lib.ac_emit_indexed(_u8(_c(records["color"])), _u8(_c(gidx)), b, h, w,
                            1 if mode == "16color" else 0, _u8(_table_luma(palette)), pad_w, pad_h,
                            _u8(out), stride, lens_p, nthreads)
    elif mode in ("16color_dithered", "16color_dithered_bg"):
        lib.ac_emit_16_dithered(_u8(_c(records["rgb"])), _u8(_c(records["luma"])), b, h, w,
                                1 if mode.endswith("_bg") else 0, _u8(_table_ramp(palette)),
                                _u8(_table_luma(palette)),
                                pad_w, pad_h, _u8(out), stride, lens_p, nthreads)
    elif mode == "halfblock_truecolor":
        lib.ac_emit_halfblock_truecolor(_u8(_c(records["top"])), _u8(_c(records["bot"])), b, h, w,
                                        pad_w, pad_h, _u8(out), stride, lens_p, nthreads)
    elif mode in ("halfblock_256", "halfblock_16"):
        lib.ac_emit_halfblock_indexed(_u8(_c(records["fg"])), _u8(_c(records["bg"])),
                                      _u8(_c(records["transparent"])), b, h, w,
                                      1 if mode == "halfblock_16" else 0,
                                      pad_w, pad_h, _u8(out), stride, lens_p, nthreads)
    else:  # halfblock_mono (mode validated above)
        lib.ac_emit_halfblock_mono(_u8(_c(records["top"])), _u8(_c(records["bot"])), b, h, w,
                                   pad_w, pad_h, _u8(out), stride, lens_p, nthreads)

    if lens.min(initial=0) < 0:
        # a native worker threw (bad_alloc in per-frame scratch): the C side
        # catches it at the thread barrier and marks every frame -1 rather
        # than letting the exception terminate/unwind the process
        raise MemoryError("native emitter worker failed (allocation)")
    if not copy:
        # zero-copy ndarray views (buffer protocol: zstd/socket/crc consume
        # them directly); valid until this thread's next emit_frames call
        return [out[i, : lens[i]] for i in range(b)]
    return [out[i, : lens[i]].tobytes() for i in range(b)]
