"""Synchronization debugging: named-lock registry + state dump + lock-order
cycle detection.

Counterpart of lib/debug/{named,mutex,sync}.c: every tracked lock has a
NAME, its current holder / hold time / acquisition + contention counters are
inspectable at runtime (dump_state feeds the inspector's /state/sync
endpoint, the analog of debug_sync_print_state), and the lock-ORDER graph is
recorded so inconsistent acquisition orders (the classic AB/BA deadlock
precursor) are detectable in tests and soaks — the reference's sync
debugging is compiled into debug builds; here tracking is always on and
costs two monotonic() calls per acquisition.
"""

from __future__ import annotations

import threading
import time

_registry: dict[str, "NamedLock"] = {}
_registry_lock = threading.Lock()
# lock-order graph: edges (held_name -> acquired_name) observed at runtime
_order_edges: set[tuple[str, str]] = set()
_held = threading.local()  # per-thread stack of held lock names
# monotonic suffix allocator per base name: freed '#N' names are NEVER
# reused — a new lock inheriting a dead lock's ordering history produces
# false cycles (the per-instance edges are purged at unregister instead)
_name_seq: dict[str, int] = {}


class NamedLock:
    """A named, instrumented threading.Lock (debug/mutex.c mutex_t analog)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.acquisitions = 0
        self.contentions = 0  # acquisitions that had to wait
        self.total_hold_s = 0.0
        self.max_hold_s = 0.0
        self.holder: str | None = None
        self.acquired_at: float | None = None
        self._owner_stack: list | None = None  # acquiring thread's stack
        with _registry_lock:
            if name in _registry or name in _name_seq:
                # per-instance locks (per-client codec contexts etc.) get a
                # disambiguating suffix; unregister() drops them on close.
                # Suffixes are MONOTONIC per base name (never reused).
                i = _name_seq.get(name, 1) + 1
                _name_seq[name.partition("#")[0]] = i
                name = self.name = f"{name}#{i}"
            else:
                _name_seq[name] = 1
            _registry[name] = self

    def unregister(self) -> None:
        """Drop from the registry AND purge this lock's ordering edges
        (debug/named.c unregister analog). Without the purge, dead
        per-instance locks' edges accumulate unboundedly and keep feeding
        the cycle detector history from objects that no longer exist."""
        with _registry_lock:
            _registry.pop(self.name, None)
            stale = [e for e in _order_edges if self.name in e]
            _order_edges.difference_update(stale)

    def acquire(self, timeout: float = -1) -> bool:
        stack = getattr(_held, "names", None)
        if stack is None:
            stack = _held.names = []
            _held.seen = set()  # edges this thread already reported
        # record ordering edges BEFORE blocking (the would-be deadlock is
        # exactly the case where we never return from acquire). The global
        # lock is only taken for edges this THREAD has not seen yet —
        # steady state adds nothing, so nested acquisitions don't all
        # serialize on one process-wide lock.
        if stack:
            new = [(h, self.name) for h in stack
                   if (h, self.name) not in _held.seen]
            if new:
                _held.seen.update(new)
                with _registry_lock:
                    _order_edges.update(new)
        got = self._lock.acquire(blocking=False)
        if not got:
            self.contentions += 1
            got = self._lock.acquire(timeout=timeout)
            if not got:
                return False
        self.acquisitions += 1
        self.holder = threading.current_thread().name
        self.acquired_at = time.monotonic()
        stack.append(self.name)
        self._owner_stack = stack
        return True

    def release(self) -> None:
        now = time.monotonic()
        if self.acquired_at is not None:
            held = now - self.acquired_at
            self.total_hold_s += held
            self.max_hold_s = max(self.max_hold_s, held)
        self.holder = None
        self.acquired_at = None
        # remove from the ACQUIRING thread's stack, not the releasing
        # thread's: a cross-thread release (hand-off pattern, legal for
        # threading.Lock) must not leave a phantom held-entry that
        # generates false ordering edges forever after
        stack = self._owner_stack
        if stack is None:
            stack = getattr(_held, "names", None)
        self._owner_stack = None
        if stack and self.name in stack:
            stack.remove(self.name)  # GIL-atomic list op; owner only appends
        self._lock.release()

    def __enter__(self) -> "NamedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def snapshot(self) -> dict:
        at = self.acquired_at
        return {
            "holder": self.holder,
            "held_for_ms": round((time.monotonic() - at) * 1e3, 3) if at else None,
            "acquisitions": self.acquisitions,
            "contentions": self.contentions,
            "total_hold_ms": round(self.total_hold_s * 1e3, 3),
            "max_hold_ms": round(self.max_hold_s * 1e3, 3),
        }


def dump_state() -> dict:
    """All tracked locks + the observed ordering edges
    (debug_sync_print_state analog; inspector /state/sync)."""
    with _registry_lock:
        locks = {name: lk.snapshot() for name, lk in _registry.items()}
        edges = sorted(_order_edges)
    return {
        "locks": locks,
        "order_edges": edges,
        "order_cycles": find_order_cycles(),
    }


def find_order_cycles() -> list[list[str]]:
    """Cycles in the observed lock-order graph: each is a potential deadlock
    (two threads acquiring the same pair of locks in opposite orders)."""
    graph: dict[str, set[str]] = {}
    with _registry_lock:
        edges = list(_order_edges)
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: list[list[str]] = []
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    path: list[str] = []

    def visit(node: str) -> None:
        color[node] = GRAY
        path.append(node)
        for nxt in graph.get(node, ()):  # noqa: B020
            c = color.get(nxt, WHITE)
            if c == GRAY:
                cycles.append(path[path.index(nxt):] + [nxt])
            elif c == WHITE:
                visit(nxt)
        path.pop()
        color[node] = BLACK

    for node in list(graph):
        if color.get(node, WHITE) == WHITE:
            visit(node)
    return cycles


def assert_no_order_cycles() -> None:
    """Test/soak gate: fail when any inconsistent lock order was observed."""
    cycles = find_order_cycles()
    if cycles:
        raise AssertionError(f"lock-order cycles detected: {cycles}")


def reset() -> None:
    """Clear the registry + order graph (test isolation). Per-thread seen
    caches are left: they only suppress re-adding edges, and stale entries
    are harmless once the graph restarts... except in tests asserting edge
    sets — those run single-threaded and clear their own thread's cache."""
    with _registry_lock:
        _registry.clear()
        _order_edges.clear()
        _name_seq.clear()
    if getattr(_held, "names", None) is not None:
        _held.seen = set()
