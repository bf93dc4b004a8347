"""Browser client HTTP routing: serves the web app next to the WebSocket.

The port's copy of ``asciichat_tpu/apps/webclient.py``, without its WebRTC
gateway (``WebRtcGateway``, not ported yet: ROADMAP.md Queue 1 item 18).

Parity with the reference's web stack (web/ TypeScript app + src/web/
main_wasm.c WASM render core served to browsers over the WebSocket
transport): the server's WebSocket listener answers plain HTTP GETs with
the static app from asciichat_tpu_torch/web/ (parse-once cell-grid renderer
on canvas), plus one dynamic endpoint:

- /servers.json — LAN server browse via one mDNS sweep (client --browse in
  the browser; lib/network/mdns/ role), cached a few seconds.
"""

from __future__ import annotations

import json
import threading
import time

from asciichat_tpu_torch import web


class _BrowseCache:
    """mDNS sweeps are 2 s blocking scans: serve a cached roster and refresh
    it in a background thread at most every `ttl` seconds."""

    def __init__(self, ttl: float = 5.0):
        self.ttl = ttl
        self._result: list[dict] = []
        self._stamp = 0.0
        self._busy = False
        self._lock = threading.Lock()

    def get(self) -> list[dict]:
        with self._lock:
            stale = time.monotonic() - self._stamp > self.ttl
            if stale and not self._busy:
                self._busy = True
                threading.Thread(target=self._refresh, daemon=True).start()
            return list(self._result)

    def _refresh(self) -> None:
        result = None
        try:
            from asciichat_tpu_torch.net.mdns import discover

            found = discover(timeout=2.0)
            result = [
                {"name": s.instance, "host": s.address, "port": s.port,
                 "ws": s.txt.get("ws", "0")}
                for s in found
            ]
        except Exception:
            pass  # transient sweep failure: keep the last-good roster
        with self._lock:
            if result is not None:
                self._result = result
            self._stamp = time.monotonic()
            self._busy = False


def make_http_handler():
    """A `pages` callable for net.websocket.serve_ws: the static assets and
    /servers.json."""
    cache = _BrowseCache()

    def handler(path: str) -> tuple[str, bytes] | None:
        route = path.split("?", 1)[0]
        if route == "/servers.json":
            return ("application/json", json.dumps(cache.get()).encode())
        return web.get_asset(route)

    return handler
