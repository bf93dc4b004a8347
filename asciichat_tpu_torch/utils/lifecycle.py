"""Init-once lifecycle guards (lib/lifecycle.c analog).

The reference wraps every lazily-initialized subsystem in a lifecycle struct
(thread-safe init-once + shutdown, used e.g. by the palette caches,
lib/video/ascii/common.c:137-149). Python analog: a named registry of
once-guards with ordered shutdown hooks.
"""

from __future__ import annotations

import threading
from typing import Callable

_lock = threading.RLock()  # reentrant: init_fn may init_once a dependency
_initialized: dict[str, bool] = {}
_shutdown_hooks: list[tuple[str, Callable[[], None]]] = []


def init_once(name: str, init_fn: Callable[[], None] | None = None) -> bool:
    """Returns True exactly once per name (running init_fn under the lock)."""
    with _lock:
        if _initialized.get(name):
            return False
        if init_fn is not None:
            init_fn()
        _initialized[name] = True
        return True


def is_initialized(name: str) -> bool:
    with _lock:
        return bool(_initialized.get(name))


def on_shutdown(name: str, fn: Callable[[], None]) -> None:
    with _lock:
        _shutdown_hooks.append((name, fn))


def shutdown_all() -> None:
    """Run shutdown hooks in reverse registration order (asciichat_shared_destroy).

    State is cleared AFTER the hooks run: a hook that init_once()s a
    dependency mid-teardown must see the truth (still initialized), and a
    shutdown hook that dependency registers joins THIS round (drained until
    quiescent) instead of being stranded in a just-cleared list while its
    subsystem stays marked initialized with live resources."""
    for _round in range(8):  # bounded: a hook-registering hook can't spin us
        with _lock:
            hooks = list(reversed(_shutdown_hooks))
            _shutdown_hooks.clear()
        if not hooks:
            break
        for _name, fn in hooks:
            try:
                fn()
            except Exception:
                pass
    with _lock:
        _initialized.clear()
