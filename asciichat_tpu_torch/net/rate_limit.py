"""SQLite-backed rate limiter for the discovery service.

Parity with lib/network/rate_limit/ (rate_limiter_create_sqlite, used at
src/discovery-service/server.c:216): sliding-window counts per (client,
action) persisted in SQLite so restarts keep limits.

The port's copy of ``asciichat_tpu/net/rate_limit.py``.
"""

from __future__ import annotations

import sqlite3
import time

DEFAULT_LIMITS = {
    "session_create": (10, 60.0),  # 10 per minute
    "session_lookup": (60, 60.0),
    "session_join": (30, 60.0),
    "string_reserve": (5, 60.0),
    "connection": (30, 60.0),
    # election triggers fan out to N signed sends + DB writes per packet
    "host_announce": (12, 60.0),
}


class RateLimiter:
    def __init__(self, path: str = ":memory:", limits: dict | None = None):
        self.db = sqlite3.connect(path)
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS rate_events ("
            " client TEXT NOT NULL, action TEXT NOT NULL, at REAL NOT NULL)"
        )
        self.db.execute(
            "CREATE INDEX IF NOT EXISTS idx_rate ON rate_events (client, action, at)"
        )
        self.limits = dict(DEFAULT_LIMITS)
        if limits:
            self.limits.update(limits)
        self._ops = 0

    def allow(self, client: str, action: str) -> bool:
        """Record + check; False when over the window limit."""
        limit, window = self.limits.get(action, (60, 60.0))
        now = time.time()
        # prune ONLY this (client, action): an unscoped delete keyed on the
        # CURRENT action's window let any short-window action (10 s lookup)
        # purge the history that long-window limits (hourly reserves)
        # depend on — a sliding-window bypass. Scoping also turns the
        # full-table scan into an (client, action, at) index range.
        self.db.execute(
            "DELETE FROM rate_events WHERE client=? AND action=? AND at < ?",
            (client, action, now - window))
        (count,) = self.db.execute(
            "SELECT COUNT(*) FROM rate_events WHERE client=? AND action=? AND at >= ?",
            (client, action, now - window),
        ).fetchone()
        if count >= limit:
            self.db.commit()
            return False
        self.db.execute(
            "INSERT INTO rate_events VALUES (?,?,?)", (client, action, now)
        )
        # periodic global sweep at the LONGEST configured window: rows from
        # clients that never come back must still age out, and pruning past
        # max(window) can never affect any action's live count
        self._ops += 1
        if self._ops % 1024 == 0:
            horizon = now - max(w for _, w in self.limits.values())
            self.db.execute("DELETE FROM rate_events WHERE at < ?", (horizon,))
        self.db.commit()
        return True
