"""Live-process inspector over HTTP (ascii-query-server analog).

The reference ships an out-of-process C++ tool that attaches LLDB to a live
ascii-chat process and serves variable inspection over HTTP
(src/tooling/query/main.cpp:1-60). Python processes can introspect
themselves, so this runtime embeds the inspector: a background HTTP server
exposing thread stacks, GC stats, the current options snapshot, and
app-registered state providers. Also covers the reference's SIGUSR1 sync-dump
and SIGUSR2 memory-report hooks (src/main.c:323-338) via /threads and /gc.
"""

from __future__ import annotations

import gc
import http.server
import json
import sys
import threading
import traceback
from typing import Any, Callable


class Inspector:
    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.providers: dict[str, Callable[[], Any]] = {}
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self.host = host
        self.port = port

    def register(self, name: str, provider: Callable[[], Any]) -> None:
        """Expose `provider()` (JSON-serializable) at /state/<name>."""
        self.providers[name] = provider

    # -- built-in endpoints -------------------------------------------------
    def _threads(self) -> dict:
        frames = sys._current_frames()
        out = {}
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            # keyed by name-AND-ident: thread names are not unique (two
            # DeviceStreams share 'pipeline-fetch'), and a name-only key
            # silently dropped one stack — possibly the deadlocked one this
            # endpoint exists to find
            out[f"{t.name}-{t.ident}"] = {
                "daemon": t.daemon,
                "alive": t.is_alive(),
                "stack": traceback.format_stack(frame) if frame else [],
            }
        return out

    def _gc(self) -> dict:
        counts = gc.get_count()
        return {
            "counts": counts,
            "objects": len(gc.get_objects()),
            "garbage": len(gc.garbage),
        }

    def _memory(self) -> dict:
        """Top allocation sites (debug-memory leak report parity,
        lib/debug/memory.c); starts tracemalloc on first call."""
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return {"status": "tracing started; call again for a snapshot"}
        snap = tracemalloc.take_snapshot()
        top = snap.statistics("lineno")[:15]
        return {
            "top_allocations": [
                {"site": str(s.traceback), "kb": s.size // 1024, "count": s.count}
                for s in top
            ]
        }

    def start(self) -> int:
        inspector = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    # query strings are routing noise ('/health?x'), and
                    # provider names may need %-decoding ('frame%20age')
                    from urllib.parse import unquote

                    route = self.path.split("?", 1)[0]
                    if route == "/health":
                        body = {"ok": True}
                    elif route == "/threads":
                        body = inspector._threads()
                    elif route == "/gc":
                        body = inspector._gc()
                    elif route == "/memory":
                        body = inspector._memory()
                    elif route == "/state":
                        body = sorted(inspector.providers)
                    elif route.startswith("/state/"):
                        name = unquote(route[len("/state/"):])
                        provider = inspector.providers.get(name)
                        if provider is None:
                            self.send_error(404, f"no provider {name!r}")
                            return
                        body = provider()
                    else:
                        self.send_error(404)
                        return
                    data = json.dumps(body, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except Exception as e:  # inspector must never kill the app
                    try:
                        # the status line must stay one latin-1 line: raw
                        # multi-line / non-latin-1 exception text (common in
                        # jax/numpy errors) corrupted the response or lost
                        # it entirely — detail goes in the explain body
                        brief = str(e).splitlines()[0][:120] if str(e) else ""
                        brief = brief.encode("latin-1", "replace").decode("latin-1")
                        self.send_error(500, f"provider failed: {type(e).__name__}",
                                        explain=f"{type(e).__name__}: {brief}")
                    except Exception:
                        pass

        self._httpd = http.server.ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="inspector").start()
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            # shutdown() stops serve_forever but leaves the listening
            # socket open — repeated start/stop cycles leaked fds and a
            # fixed inspect_port could hit address-in-use on quick restart
            self._httpd.server_close()
            self._httpd = None
