"""Build and load the hand-written CUDA kernels (nvcc + ctypes, no PyTorch headers).

``csrc/*.cu`` compile with one ``nvcc`` each, all started together, and one
link into a shared library with a plain C interface, at first use, into
``build/torch_kernels/`` under the
repository root. The file name carries a hash of the sources and flags, so an
edit rebuilds and a stale library is never loaded. Pointers and the CUDA
stream pass as ``c_void_p``; every C entry returns ``cudaGetLastError()`` and
the wrapper raises on a non-zero code. Building against PyTorch's own headers
(``torch.utils.cpp_extension``) takes minutes per build; this takes seconds.

The headers that hold the kernels' per-element math (``csrc/cells_math.cuh``
for the render kernels, ``csrc/mixer_math.cuh`` for the mixer) are also
compiled by g++ into small CPU libraries (:func:`cells_math_lib`,
:func:`mixer_math_lib`), so the tests check that math on a machine with no
GPU.

The host runtime's C++ (the ANSI emitter, CRC32-C, the audio ring, the
secretbox and Argon2id primitives, the libavcodec shim) lives in the
repository root's ``native/``, which this module only reads: :func:`native_lib`
builds ``native/<name>.cpp`` with g++ into ``build/torch_native/``, under the
same content hash, so the port never shares a build directory with another
package.

Each build is a ``kernel.build`` span of the process's tracer
(``utils/trace.py``, counting ``libraries`` built), and each library's
digest and ``ctypes`` load ``kernel.load`` spans, so a process's set-up, or
a build in the middle of a run, shows in its aggregates and under
``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from asciichat_tpu_torch.utils import trace

REPO_DIR = Path(__file__).resolve().parent.parent.parent
CSRC_DIR = REPO_DIR / "asciichat_tpu_torch" / "csrc"
BUILD_DIR = REPO_DIR / "build" / "torch_kernels"
NATIVE_DIR = REPO_DIR / "native"
NATIVE_BUILD_DIR = REPO_DIR / "build" / "torch_native"

NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*NVCC_ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
NATIVE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# libraries a native source links against; they follow the source
NATIVE_LINK = {"avshim": ("-lavcodec", "-lavformat", "-lavutil", "-lswscale"),
               # Qt's runtime libraries by exact name: no Qt development package
               "qjs": ("-L/usr/lib/x86_64-linux-gnu", "-l:libQt5Qml.so.5",
                       "-l:libQt5Core.so.5")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry points of libkernels and their argument types (csrc/*.cu).
ENTRY_POINTS: dict[str, list] = {
    "ac_resize_nn": [_P, _I64, _I64, _I64, _P, _I, _P, _I, _P, _P],
    "ac_cell_records": [_I, _P, _I64, _I64, _I64, _P, _I, _P, _I, _P,
                        _P, _P, _P, _P],
    "ac_render_groups": [_P, _P, _I, _P],
    "ac_mixer": [_P, _P, _I, _I64, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                 _P, _P],
    "ac_capture_chain": [_P, _P, _I, _I, _I, _I, *[_P] * 7, _P, _P, *[_P] * 7, _P],
    "ac_device_emit": [_P, _P, _P, _I, _I, _I, _P, _I64, _P, _P, _I64, _P],
    "ac_copy_rows": [_P, _I64, _I64, _I64, _I64, _P, _I, _P, _P],
}


def _sources(pattern: str) -> list[Path]:
    return sorted(CSRC_DIR.glob(pattern))


def _digest(paths: list[Path], flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd_prefix: list[str], sources: list[Path], out: Path,
             link: tuple[str, ...] = ()) -> str:
    """Compile to a per-process temporary name, then rename: a concurrent
    loader never sees a half-written library. Returns the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [*cmd_prefix, "-o", str(tmp), *map(str, sources), *link]
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


def library_digest() -> str:
    """The digest of the kernel library's sources and flags: its file name
    carries it, so equal digests mean the same kernels."""
    return _digest(_sources("*.cu") + _sources("*.cuh"), NVCC_FLAGS)


def build_cuda(verbose: bool = False) -> tuple[Path, str]:
    """Build libkernels if no library for the current sources exists: one
    nvcc per source, all at once (the build takes as long as its slowest
    source, not the sum of all), then one link. Returns (path, compiler
    output); ``verbose`` adds ``-Xptxas -v`` (each kernel's registers, shared
    memory and spills) to a fresh build."""
    units = _sources("*.cu")
    with trace.span("kernel.load"):
        out = BUILD_DIR / f"libkernels-{library_digest()}.so"
        if out.exists():
            return out, ""
    nvcc = nvcc_path()
    flags = [f for f in NVCC_FLAGS if f != "-shared"] + (["-Xptxas", "-v"] if verbose else [])
    objs = BUILD_DIR / f"objects-{out.stem}-{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    try:
        with trace.span("kernel.build") as build:
            jobs = [(unit, subprocess.Popen(
                [nvcc, *flags, "-c", f"-I{CSRC_DIR}", "-o", str(objs / f"{unit.stem}.o"), str(unit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for unit in units]
            texts = [job.communicate()[0] for _, job in jobs]  # every job ends first
            for (unit, job), text in zip(jobs, texts):
                if job.returncode != 0:
                    raise RuntimeError(f"kernel build failed ({unit.name}):\n{text[-6000:]}")
            log = "".join(texts)
            link = [nvcc, *NVCC_ARCH, "-shared"]
            log += _compile(link, sorted(objs.glob("*.o")), out)
            build.add("libraries")
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    return out, log


@functools.lru_cache(maxsize=None)
def cuda_lib() -> ctypes.CDLL:
    """libkernels, built at first use, with every entry point's types set."""
    path, _ = build_cuda()
    with trace.span("kernel.load"):
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


@contextlib.contextmanager
def _build_lock(out: Path):
    """One compile of ``out`` at a time, across threads and processes (the
    server and its clients, parallel test workers); the others wait, then
    load what it built."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(f".{out.name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        yield


@functools.lru_cache(maxsize=None)
def native_lib(name: str) -> ctypes.CDLL:
    """native/<name>.cpp built with g++ into build/torch_native/ at first use
    (with ``-march=native`` where the toolchain takes it: CRC32-C uses SSE4.2)."""
    src = NATIVE_DIR / f"{name}.cpp"
    link = NATIVE_LINK.get(name, ())
    with trace.span("kernel.load"):
        out = NATIVE_BUILD_DIR / f"lib{name}-{_digest([src], NATIVE_FLAGS + link)}.so"
        found = out.exists()
    if not found:
        # the wait for another process's build of the same library counts too
        with trace.span("kernel.build") as build, _build_lock(out):
            if not out.exists():
                cxx = os.environ.get("CXX", "g++")
                try:
                    _compile([cxx, "-march=native", *NATIVE_FLAGS], [src], out, link)
                except RuntimeError:
                    _compile([cxx, *NATIVE_FLAGS], [src], out, link)
                build.add("libraries")
    with trace.span("kernel.load"):
        return ctypes.CDLL(str(out))


@functools.lru_cache(maxsize=None)
def emitter_lib() -> ctypes.CDLL:
    """native/emitter.cpp, the multithreaded ANSI emitter, with its entry
    points' types set."""
    lib = native_lib("emitter")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    c_int = ctypes.c_int
    c_i64 = ctypes.c_int64

    lib.ac_emit_mono.argtypes = [u8p, c_int, c_int, c_int, u8p, c_int, c_int, u8p, c_i64, i64p, c_int]
    lib.ac_emit_truecolor_fg.argtypes = [u8p, u8p, c_int, c_int, c_int, u8p, c_int, c_int, u8p, c_i64, i64p, c_int]
    lib.ac_emit_indexed.argtypes = [u8p, u8p, c_int, c_int, c_int, c_int, u8p, c_int, c_int, u8p, c_i64, i64p, c_int]
    lib.ac_emit_16_dithered.argtypes = [u8p, u8p, c_int, c_int, c_int, c_int, u8p, u8p, c_int, c_int, u8p, c_i64, i64p, c_int]
    lib.ac_emit_halfblock_truecolor.argtypes = [u8p, u8p, c_int, c_int, c_int, c_int, c_int, u8p, c_i64, i64p, c_int]
    lib.ac_emit_halfblock_indexed.argtypes = [u8p, u8p, u8p, c_int, c_int, c_int, c_int, c_int, c_int, u8p, c_i64, i64p, c_int]
    lib.ac_emit_halfblock_mono.argtypes = [u8p, u8p, c_int, c_int, c_int, c_int, c_int, u8p, c_i64, i64p, c_int]
    for fn in (
        lib.ac_emit_mono,
        lib.ac_emit_truecolor_fg,
        lib.ac_emit_indexed,
        lib.ac_emit_16_dithered,
        lib.ac_emit_halfblock_truecolor,
        lib.ac_emit_halfblock_indexed,
        lib.ac_emit_halfblock_mono,
    ):
        fn.restype = None
    return lib
