"""Build and load the hand-written CUDA kernels (nvcc + ctypes, no PyTorch headers).

``csrc/*.cu`` compile with one ``nvcc`` call into a shared library with a
plain C interface, at first use, into ``build/torch_kernels/`` under the
repository root. The file name carries a hash of the sources and flags, so an
edit rebuilds and a stale library is never loaded. Pointers and the CUDA
stream pass as ``c_void_p``; every C entry returns ``cudaGetLastError()`` and
the wrapper raises on a non-zero code. Building against PyTorch's own headers
(``torch.utils.cpp_extension``) takes minutes per build; this takes seconds.

The headers that hold the kernels' per-element math (``csrc/cells_math.cuh``
for the render kernels, ``csrc/mixer_math.cuh`` for the mixer) are also
compiled by g++ into small CPU libraries (:func:`cells_math_lib`,
:func:`mixer_math_lib`), following ``asciichat_tpu/runtime/native_build.py``,
so the tests check that math on a machine with no GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points of libkernels and their argument types (csrc/*.cu).
ENTRY_POINTS: dict[str, list] = {
    "ac_resize_nn": [_P, _I64, _I64, _I64, _P, _I, _P, _I, _P, _P],
    "ac_cell_records": [_I, _P, _I64, _I64, _I64, _P, _I, _P, _I, _P,
                        _P, _P, _P, _P],
    "ac_render_group": [_I, _P, _I64, _I64, _P, _P, _P, _I, _I, _P, _P, _P,
                        _P, _I64, _P, _P, _P, _P, _P],
    "ac_mixer": [_P, _P, _I, _I64, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                 _P, _P],
}


def _sources(pattern: str) -> list[Path]:
    return sorted(CSRC_DIR.glob(pattern))


def _digest(paths: list[Path], flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd_prefix: list[str], sources: list[Path], out: Path) -> str:
    """Compile to a per-process temporary name, then rename: a concurrent
    loader never sees a half-written library. Returns the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [*cmd_prefix, "-o", str(tmp), *map(str, sources)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                               f"{r.stderr[-6000:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return r.stdout + r.stderr


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build_cuda(verbose: bool = False) -> tuple[Path, str]:
    """Build libkernels if no library for the current sources exists.
    Returns (path, compiler output); ``verbose`` adds ``-Xptxas -v`` (each
    kernel's registers, shared memory and spills) to a fresh build."""
    units = _sources("*.cu")
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    digest = _digest(units + _sources("*.cuh"), NVCC_FLAGS)
    out = BUILD_DIR / f"libkernels-{digest}.so"
    if out.exists():
        return out, ""
    log = _compile([nvcc_path(), *flags, f"-I{CSRC_DIR}"], units, out)
    return out, log


@functools.lru_cache(maxsize=None)
def cuda_lib() -> ctypes.CDLL:
    """libkernels, built at first use, with every entry point's types set."""
    path, _ = build_cuda()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ac_error_string.argtypes = [ctypes.c_int]
    lib.ac_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One hand-written kernel: its C entry point and how often it launched.

    ``launches`` is a plain count that this object adds one to each time it
    launches the kernel, and nowhere else, so a run can show that its main
    path went through the kernel."""

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        if entry not in ENTRY_POINTS:
            raise ValueError(f"unknown entry point {entry!r}")
        self.name = name
        self.entry = entry
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, *args) -> None:
        lib = cuda_lib()
        rc = getattr(lib, self.entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch: "
                               f"{lib.ac_error_string(rc).decode()}")
        self.launches += 1


def _host_lib(stem: str, header: str) -> ctypes.CDLL:
    """g++ build of csrc/<stem>_host.cpp over csrc/<header>."""
    src = CSRC_DIR / f"{stem}_host.cpp"
    digest = _digest([src, CSRC_DIR / header], GXX_FLAGS)
    out = BUILD_DIR / f"lib{stem}-{digest}.so"
    if not out.exists():
        _compile([os.environ.get("CXX", "g++"), *GXX_FLAGS, f"-I{CSRC_DIR}"],
                 [src], out)
    return ctypes.CDLL(str(out))


@functools.lru_cache(maxsize=None)
def cells_math_lib() -> ctypes.CDLL:
    """g++ build of csrc/cells_math_host.cpp: the kernels' per-element math
    over arrays of RGB triples, for the CPU tests."""
    lib = _host_lib("cells_math", "cells_math.cuh")
    for name in ("cm_luma", "cm_q256", "cm_q16"):
        getattr(lib, name).argtypes = [_P, _I64, _P]
    lib.cm_mono_key.argtypes = [_P, _I64, _P, _P]
    lib.cm_color_filter.argtypes = [_P, _I64, _I, _I, _I, _I, _I, _I, _P]
    lib.cm_hb_bot_row.argtypes = [_I, _I]
    lib.cm_pixel_offset.argtypes = [_I64] * 5
    lib.cm_pixel_offset.restype = _I64
    for name in ("cm_luma", "cm_mono_key", "cm_q256", "cm_q16", "cm_color_filter"):
        getattr(lib, name).restype = None
    return lib


@functools.lru_cache(maxsize=None)
def mixer_math_lib() -> ctypes.CDLL:
    """g++ build of csrc/mixer_math_host.cpp: K4's scalar math over float32
    arrays, for the CPU tests."""
    lib = _host_lib("mixer_math", "mixer_math.cuh")
    for name in ("mm_db_to_linear", "mm_linear_to_db"):
        getattr(lib, name).argtypes = [_P, _I64, _P]
    for name in ("mm_attack_release", "mm_gain_smooth"):
        getattr(lib, name).argtypes = [_P, _P, _I64, _F, _F, _P]
    for name in ("mm_gain_reduction_db", "mm_crowd_gain", "mm_soft_clip"):
        getattr(lib, name).argtypes = [_P, _I64, _P, _P]
    for name in ("mm_db_to_linear", "mm_linear_to_db", "mm_attack_release",
                 "mm_gain_smooth", "mm_gain_reduction_db", "mm_crowd_gain",
                 "mm_soft_clip"):
        getattr(lib, name).restype = None
    lib.mm_consts_count.argtypes = []
    lib.mm_consts_count.restype = _I
    return lib
