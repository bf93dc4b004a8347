"""Discovery sessions: memorable word-strings + SQLite session database.

Parity with lib/discovery/ + src/discovery-service/server.c:209-223:
- session strings are "adjective-noun-noun" (lib/discovery/strings.c:6)
  drawn from word lists (ours are original, not the reference's lists)
- sessions persist in SQLite with host/participant addressing, join/leave/
  reconnect, expiry, and string reservations (ACIP_STRING_RESERVE/RENEW/
  RELEASE, packet.h:6020-6023)

The port's copy of ``asciichat_tpu/net/discovery.py``.
"""

from __future__ import annotations

import dataclasses
import secrets
import sqlite3
import time

# Original word lists (the reference ships its own 360/725-word lists; these
# are this project's, same format and role).
ADJECTIVES = [
    "amber", "arctic", "bold", "brave", "bright", "brisk", "calm", "cedar",
    "clever", "cobalt", "cosmic", "crimson", "crisp", "daring", "dawn",
    "deep", "dusty", "eager", "early", "ember", "fable", "fleet", "frosty",
    "gentle", "gilded", "glad", "golden", "grand", "green", "happy", "hardy",
    "hidden", "humble", "indigo", "ivory", "jade", "jolly", "keen", "kind",
    "late", "lively", "lucky", "lunar", "mellow", "mighty", "misty", "noble",
    "north", "old", "opal", "pale", "polar", "proud", "quick", "quiet",
    "rapid", "rosy", "rustic", "sable", "sage", "sandy", "scarlet", "sharp",
    "silent", "silver", "sleek", "smooth", "snowy", "solar", "steady",
    "stormy", "sunny", "swift", "tall", "tidal", "topaz", "tranquil", "true",
    "vivid", "warm", "wild", "windy", "wise", "young", "zesty",
]
NOUNS = [
    "anchor", "arrow", "aspen", "badger", "bay", "beacon", "bear", "birch",
    "bison", "bluff", "brook", "canyon", "cave", "cliff", "cloud", "comet",
    "coral", "crane", "creek", "crow", "delta", "dune", "eagle", "echo",
    "elk", "ember", "falcon", "fern", "field", "fjord", "flame", "forest",
    "fox", "gale", "garden", "geyser", "glacier", "glade", "grove", "harbor",
    "hawk", "heron", "hill", "island", "jungle", "lagoon", "lake", "lark",
    "lily", "lynx", "maple", "marsh", "meadow", "mesa", "moon", "moose",
    "moss", "mountain", "oak", "ocean", "orchid", "osprey", "otter", "owl",
    "peak", "pebble", "pine", "plain", "pond", "prairie", "rain", "raven",
    "reef", "ridge", "river", "rock", "rose", "sea", "shore", "sky",
    "sparrow", "spring", "star", "stone", "storm", "stream", "summit",
    "sun", "thicket", "thunder", "tide", "trail", "tundra", "valley",
    "vine", "water", "wave", "willow", "wind", "wolf", "wren",
]


def generate_session_string() -> str:
    """adjective-noun-noun, e.g. "swift-river-mountain" (strings.c:6)."""
    return "-".join(
        (
            secrets.choice(ADJECTIVES),
            secrets.choice(NOUNS),
            secrets.choice(NOUNS),
        )
    )


def validate_session_string(s: str) -> bool:
    parts = s.split("-")
    return (
        len(parts) == 3
        and parts[0] in ADJECTIVES
        and parts[1] in NOUNS
        and parts[2] in NOUNS
    )


@dataclasses.dataclass
class SessionInfo:
    session_string: str
    session_id: str
    host_id: str
    host_address: str
    host_port: int
    created_at: float
    participants: list[str]


# Sessions expire on INACTIVITY, refreshed by membership/host updates and
# relayed traffic — the reference keys expiry on last_activity_at the same
# way (database.c:871 refresh, :575 expiry scan), so an actively-used
# session never vanishes mid-call and an abandoned string frees after the
# idle window instead of squatting for a day.
SESSION_IDLE_TTL_S = 3 * 3600
RESERVATION_TTL_S = 300


class SessionDatabase:
    """SQLite session store (src/discovery-service/server.c:209-223 analog)."""

    def __init__(self, path: str = ":memory:"):
        self.db = sqlite3.connect(path)
        self.db.executescript(
            """
            CREATE TABLE IF NOT EXISTS sessions (
                session_string TEXT PRIMARY KEY,
                session_id TEXT NOT NULL,
                host_id TEXT NOT NULL,
                host_address TEXT NOT NULL,
                host_port INTEGER NOT NULL,
                created_at REAL NOT NULL,
                ended INTEGER DEFAULT 0,
                last_activity_at REAL DEFAULT 0
            );
            CREATE TABLE IF NOT EXISTS participants (
                session_string TEXT NOT NULL,
                participant_id TEXT NOT NULL,
                address TEXT,
                port INTEGER,
                joined_at REAL NOT NULL,
                PRIMARY KEY (session_string, participant_id)
            );
            CREATE TABLE IF NOT EXISTS reservations (
                session_string TEXT PRIMARY KEY,
                owner_id TEXT NOT NULL,
                reserved_at REAL NOT NULL
            );
            """
        )
        try:  # migrate pre-activity-column DBs in place
            self.db.execute(
                "ALTER TABLE sessions ADD COLUMN last_activity_at REAL DEFAULT 0")
        except sqlite3.OperationalError:
            pass
        self._last_expire = 0.0

    # -- sessions ---------------------------------------------------------
    def create_session(
        self, host_id: str, host_address: str, host_port: int,
        session_string: str | None = None, owner_id: str | None = None,
    ) -> SessionInfo:
        """`owner_id` is the identity reservations are keyed by (the ACDS
        reserves under the VERIFIED identity hex, not the participant id);
        defaults to host_id for direct users of this class."""
        self._expire()
        if owner_id is None:
            owner_id = host_id
        if session_string is not None:
            # explicit strings come from untrusted SESSION_CREATE payloads:
            # enforce the word-list contract (an arbitrary multi-MB blob
            # must not become a PRIMARY KEY echoed in broadcasts), and an
            # ACTIVE reservation held by someone else blocks the create
            if not validate_session_string(session_string):
                raise ValueError(f"invalid session string {session_string!r}")
            holder = self.reservation_owner(session_string)
            if holder is not None and holder != owner_id:
                raise ValueError(
                    f"session string {session_string!r} reserved by another")
        for _ in range(32):
            s = session_string or generate_session_string()
            if session_string is None:
                # a random draw must not steal someone's live reservation
                holder = self.db.execute(
                    "SELECT owner_id FROM reservations WHERE session_string=?",
                    (s,)).fetchone()
                if holder and holder[0] != owner_id:
                    continue
            session_id = secrets.token_hex(8)
            now = time.time()
            try:
                self.db.execute(
                    "INSERT INTO sessions VALUES (?,?,?,?,?,?,0,?)",
                    (s, session_id, host_id, host_address, host_port, now, now),
                )
                break
            except sqlite3.IntegrityError:
                if session_string:  # explicit (reserved) string already taken
                    raise ValueError(f"session string {s!r} already in use")
                continue
        else:
            raise RuntimeError("could not allocate a session string")
        # a reservation is single-use: consumed by the create that used it
        self.db.execute(
            "DELETE FROM reservations WHERE session_string=? AND owner_id=?",
            (s, owner_id))
        self.db.execute(
            "INSERT OR REPLACE INTO participants VALUES (?,?,?,?,?)",
            (s, host_id, host_address, host_port, time.time()),
        )
        self.db.commit()
        return self.lookup(s)

    def touch(self, session_string: str) -> None:
        """Refresh the inactivity clock (database.c:871 role): membership
        changes, host migration, and relayed session traffic all count."""
        self.db.execute(
            "UPDATE sessions SET last_activity_at=? WHERE session_string=?",
            (time.time(), session_string))
        self.db.commit()

    def lookup(self, session_string: str) -> SessionInfo | None:
        self._expire()
        row = self.db.execute(
            "SELECT session_string, session_id, host_id, host_address, host_port,"
            " created_at FROM sessions WHERE session_string=? AND ended=0",
            (session_string,),
        ).fetchone()
        if not row:
            return None
        parts = [
            r[0]
            for r in self.db.execute(
                "SELECT participant_id FROM participants WHERE session_string=?"
                " ORDER BY joined_at",
                (session_string,),
            )
        ]
        return SessionInfo(*row, participants=parts)

    def join(self, session_string: str, participant_id: str,
             address: str = "", port: int = 0) -> SessionInfo:
        info = self.lookup(session_string)
        if info is None:
            raise KeyError(f"no such session: {session_string}")
        self.db.execute(
            "INSERT OR REPLACE INTO participants VALUES (?,?,?,?,?)",
            (session_string, participant_id, address, port, time.time()),
        )
        self.db.commit()
        self.touch(session_string)
        return self.lookup(session_string)

    def leave(self, session_string: str, participant_id: str) -> None:
        self.db.execute(
            "DELETE FROM participants WHERE session_string=? AND participant_id=?",
            (session_string, participant_id),
        )
        self.db.commit()
        self.touch(session_string)

    def end_session(self, session_string: str, host_id: str) -> bool:
        # DELETE, not a tombstone: an ended=1 row kept the PRIMARY KEY
        # occupied (lookup/reserve reported the string free while create
        # failed on the PK), and its participants rows resurfaced as ghost
        # members when the string was reused
        cur = self.db.execute(
            "DELETE FROM sessions WHERE session_string=? AND host_id=?",
            (session_string, host_id),
        )
        if cur.rowcount:
            self.db.execute(
                "DELETE FROM participants WHERE session_string=?",
                (session_string,))
        self.db.commit()
        return cur.rowcount > 0

    def set_host(self, session_string: str, host_id: str,
                 address: str, port: int) -> None:
        """Host migration after consensus election / failover."""
        self.db.execute(
            "UPDATE sessions SET host_id=?, host_address=?, host_port=?,"
            " last_activity_at=? WHERE session_string=?",
            (host_id, address, port, time.time(), session_string),
        )
        self.db.commit()

    # -- string reservations (packet.h:6020-6023) --------------------------
    def reserve_string(self, session_string: str, owner_id: str) -> bool:
        self._expire()
        if not validate_session_string(session_string):
            return False
        taken = self.db.execute(
            "SELECT 1 FROM sessions WHERE session_string=? AND ended=0",
            (session_string,),
        ).fetchone()
        if taken:
            return False
        try:
            self.db.execute(
                "INSERT INTO reservations VALUES (?,?,?)",
                (session_string, owner_id, time.time()),
            )
        except sqlite3.IntegrityError:
            row = self.db.execute(
                "SELECT owner_id FROM reservations WHERE session_string=?",
                (session_string,),
            ).fetchone()
            if row and row[0] == owner_id:
                # a same-owner re-reserve is a KEEPALIVE: acking success
                # while leaving the original reserved_at let the
                # reservation lapse at the first TTL despite the fresh ack
                self.db.execute(
                    "UPDATE reservations SET reserved_at=? WHERE"
                    " session_string=? AND owner_id=?",
                    (time.time(), session_string, owner_id),
                )
                self.db.commit()
                return True
            return False
        self.db.commit()
        return True

    def reservation_owner(self, session_string: str) -> str | None:
        """Current (unexpired) reservation holder, or None. Expiry is
        enforced IN the query: the throttled sweep can lag up to its
        interval, during which a dead reservation would still block another
        identity's SESSION_CREATE (renew_string got the same deterministic
        treatment for the same reason)."""
        self._expire()
        row = self.db.execute(
            "SELECT owner_id FROM reservations WHERE session_string=?"
            " AND reserved_at >= ?",
            (session_string, time.time() - RESERVATION_TTL_S),
        ).fetchone()
        return row[0] if row else None

    def renew_string(self, session_string: str, owner_id: str) -> bool:
        # deterministic expiry: a lapsed reservation cannot be renewed even
        # if no other traffic happened to run the expiry sweep first
        now = time.time()
        cur = self.db.execute(
            "UPDATE reservations SET reserved_at=? WHERE session_string=?"
            " AND owner_id=? AND reserved_at >= ?",
            (now, session_string, owner_id, now - RESERVATION_TTL_S),
        )
        self.db.commit()
        return cur.rowcount > 0

    def release_string(self, session_string: str, owner_id: str) -> None:
        self.db.execute(
            "DELETE FROM reservations WHERE session_string=? AND owner_id=?",
            (session_string, owner_id),
        )
        self.db.commit()

    def _expire(self) -> None:
        # throttled: lookup() sits on the per-relayed-packet hot path, and
        # unthrottled this ran 2 table-scan DELETEs + fsync per packet
        now = time.time()
        if now - self._last_expire < 2.0:
            return
        self._last_expire = now
        horizon = now - SESSION_IDLE_TTL_S
        dead = [r[0] for r in self.db.execute(
            "SELECT session_string FROM sessions WHERE"
            " max(last_activity_at, created_at) < ?", (horizon,))]
        for s in dead:
            self.db.execute("DELETE FROM sessions WHERE session_string=?", (s,))
            self.db.execute(
                "DELETE FROM participants WHERE session_string=?", (s,))
        self.db.execute(
            "DELETE FROM reservations WHERE reserved_at < ?", (now - RESERVATION_TTL_S,)
        )
        self.db.commit()
