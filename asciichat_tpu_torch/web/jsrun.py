"""Run the web client's JavaScript under a real JS engine (Qt5 QML V4).

Counterpart of ``asciichat_tpu/web/jsrun.py``. The system's
libQt5Qml.so.5 carries the complete ES6/ES7 V4 engine that QML embeds, and
``native/qjs.cpp`` binds it without Qt headers; it is built by
``runtime/kernel_build.native_lib``. This wrapper exposes one call:

    eval_js(program) -> str   (result of the last expression, stringified)

used by tests to execute all four web/ JS files: ansi.js and acip.js
against the same committed contracts their Python twins are pinned to,
renderer.js on a recorded-ops canvas shim, and app.js on the full
micro-browser in tests/data/browser_shim.js. Engine-level caveats vs a
browser: no DOM/TextEncoder/TextDecoder (tests shim them), and promise
reaction jobs never drain (no event loop inside one evaluate) — which is
why app.js is written promise-free to a Qt-V4 ES6 ceiling.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

WEB_DIR = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=1)
def _lib():
    from asciichat_tpu_torch.runtime.kernel_build import native_lib

    lib = native_lib("qjs")
    lib.ac_qjs_eval.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                ctypes.c_char_p, ctypes.c_long]
    lib.ac_qjs_eval.restype = ctypes.c_long
    return lib


def available() -> bool:
    """True when the Qt V4 engine is present and the shim builds."""
    if not Path("/usr/lib/x86_64-linux-gnu/libQt5Qml.so.5").exists():
        return False
    try:
        return eval_js("6*7") == "42"
    except Exception:
        return False


class JsError(RuntimeError):
    pass


def eval_js(program: str, out_cap: int = 1 << 22) -> str:
    """Evaluate a JS program; returns the final value's string form.
    Raises JsError on an uncaught JS exception."""
    buf = ctypes.create_string_buffer(out_cap)
    src = program.encode()
    n = _lib().ac_qjs_eval(src, len(src), buf, out_cap)
    if n == -2:
        raise JsError(f"result exceeds {out_cap} bytes")
    out = buf.raw[:n].decode("utf-8", errors="replace")
    if out.startswith("JSERROR:"):
        raise JsError(out[8:])
    return out


def load_twin(name: str) -> str:
    """Source of a web/ asset for inclusion in a test program."""
    return (WEB_DIR / name).read_text()
