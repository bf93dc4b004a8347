"""ACDS — the discovery (rendezvous) service.

Parity with src/discovery-service/: memorable session strings backed by
SQLite (server.c:209-223), join/leave/reconnect, string reservations,
SQLite-backed rate limiting (server.c:216), WebRTC SDP/ICE relay
(signaling.c:137), participant-list broadcast, and host election: clients
report NETWORK_QUALITY metrics (packet type 6060) and the service runs the
deterministic consensus election (net/consensus.elect) and broadcasts
HOST_DESIGNATED (6062) — the centralized variant of the ring protocol; the
ring state machines themselves live in net/consensus.py.

Payload encoding: structured JSON bodies inside Ed25519-signed envelopes
(net/identity.py) — the reference uses packed C structs with the same
identity-signature scheme (acds.h); packet types, signing discipline, and
session semantics match, the body encoding differs (documented divergence).

The port's copy of ``asciichat_tpu/apps/acds.py``.
"""

from __future__ import annotations

import asyncio
import json
import secrets

from asciichat_tpu_torch.net import consensus as cons
from asciichat_tpu_torch.net import identity as ident
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net.discovery import SessionDatabase
from asciichat_tpu_torch.net.rate_limit import RateLimiter
from asciichat_tpu_torch.net.transport import Transport, serve_tcp
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("acds")

ELECTION_INTERVAL_S = 300.0  # "every 5 minutes" (ring-consensus-protocol.md)

from asciichat_tpu_torch.net.packet import ACDS_SIGNED_RANGE as SIGNED_RANGE  # noqa: E501 — one protocol ground truth


def _j(obj) -> bytes:
    return json.dumps(obj).encode()


def _uj(payload: bytes) -> dict:
    return json.loads(payload.decode())


class _RelayBudget:
    """Per-sender token bucket for TURN-role data relay bandwidth.

    The ACDS blindly forwards end-to-end-encrypted ACIP_WEBRTC_RELAY
    segments when two peers' ICE fails; without a budget any client could
    use the rendezvous host as a free traffic amplifier. A token bucket
    (vs the SQLite sliding window used for control-plane actions) keeps the
    per-segment cost at a dict lookup — the relay is a media path. Over-
    budget segments are DROPPED; the channel's Go-Back-N retransmission
    then throttles the sender to the refill rate (TURN allocation-quota
    role, cf. lib/network/rate_limit/)."""

    def __init__(self, rate_bps: float = 1_000_000.0,
                 burst_bytes: float = 4_000_000.0):
        self.rate = rate_bps
        self.burst = burst_bytes
        self._state: dict[str, tuple[float, float]] = {}  # peer -> (tokens, t)

    def allow(self, peer: str, nbytes: int) -> bool:
        import time as _time

        now = _time.monotonic()
        if peer not in self._state and len(self._state) >= 4096:
            # bound the per-sender table on a long-lived public service:
            # evict the stalest entry (a stale bucket is by definition a
            # full one, so eviction never grants extra budget)
            oldest = min(self._state, key=lambda k: self._state[k][1])
            del self._state[oldest]
        tokens, at = self._state.get(peer, (self.burst, now))
        tokens = min(self.burst, tokens + (now - at) * self.rate)
        if tokens < nbytes:
            self._state[peer] = (tokens, now)
            return False
        self._state[peer] = (tokens - nbytes, now)
        return True


class AcdsServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 27225,
                 db_path: str = ":memory:", election_interval: float = ELECTION_INTERVAL_S,
                 relay_rate_bps: float = 1_000_000.0):
        self.host = host
        self.port = port
        self.db = SessionDatabase(db_path)
        self.limiter = RateLimiter(db_path)
        self.relay_budget = _RelayBudget(relay_rate_bps, 4 * relay_rate_bps)
        self.relay_dropped = 0
        self.election_interval = election_interval
        # participant_id -> (transport, session_string)
        self.clients: dict[str, tuple[Transport, str | None]] = {}
        # session_string -> {participant_id: metrics}
        self.metrics: dict[str, dict[str, cons.ParticipantMetrics]] = {}
        self.identity = ident.Identity()
        self.pins = ident.KnownPeers()  # participant_id -> pinned pubkey
        # relay hot-path caches: membership lookups (2 SELECTs) and touch
        # (UPDATE+commit/fsync) per relayed media segment would melt a
        # file-backed SQLite on this box — the same reason _expire is
        # throttled (discovery.py). Seconds-stale membership is fine: the
        # authoritative check still runs on every cache refresh.
        self._session_cache: dict[str, tuple[float, object]] = {}
        self._last_touch: dict[str, float] = {}

    def _session_info_cached(self, session_string: str, max_age: float = 2.0):
        import time as _time

        now = _time.monotonic()
        ent = self._session_cache.get(session_string)
        if ent is not None and now - ent[0] < max_age:
            return ent[1]
        if len(self._session_cache) >= 4096:
            self._session_cache.clear()  # bound on a long-lived service
        info = self.db.lookup(session_string)
        self._session_cache[session_string] = (now, info)
        return info

    def _touch_throttled(self, session_string: str,
                         min_interval: float = 5.0) -> None:
        import time as _time

        now = _time.monotonic()
        if now - self._last_touch.get(session_string, 0.0) >= min_interval:
            if len(self._last_touch) >= 4096:
                self._last_touch.clear()
            self._last_touch[session_string] = now
            self.db.touch(session_string)

    def _pin_matches(self, pid: str, pub: bytes | None) -> bool:
        """Verify against an existing pin WITHOUT creating one: pinning
        before a registration validates let failed joins squat ids."""
        if pub is None:
            return self.pins.get(pid) is None
        pinned = self.pins.get(pid)
        return pinned is None or pinned == pub

    def _pin(self, pid: str, pub: bytes | None) -> None:
        """Pin a SUCCESSFUL registration's key; bounded — when the table
        grows past the cap, ids with no live connection age out (eviction
        re-opens first-use pinning for those ids, the explicit cost of
        bounding an otherwise unbounded table)."""
        if pub is None:
            return
        pins = self.pins._pins
        if len(pins) > 8192 and pid not in pins:
            for old in list(pins):
                if old not in self.clients:
                    del pins[old]
                if len(pins) <= 4096:
                    break
        self.pins.check(pid, pub)

    def _signed_send(self, t: Transport, ptype: int, body: bytes) -> None:
        t.send_nowait(ptype, self.identity.sign(ptype, body))

    async def _broadcast_participants(self, session_string: str) -> None:
        info = self.db.lookup(session_string)
        if not info:
            return
        msg = _j({
            "session_string": session_string,
            "participants": cons.ring_order(info.participants),
            "host_id": info.host_id,
            # pinned identity keys so participants can verify each other's
            # relayed (ring/SDP) messages end-to-end
            "pubkeys": {
                p: k.hex()
                for p in info.participants
                if (k := self.pins.get(p)) is not None
            },
        })
        for pid in info.participants:
            entry = self.clients.get(pid)
            if entry:
                self._signed_send(entry[0], pkt.PacketType.ACIP_PARTICIPANT_LIST, msg)

    def _broadcast_host(self, session_string: str, host_id: str,
                        address: str, port: int, backup_id: str | None) -> None:
        info = self.db.lookup(session_string)
        if not info:
            return
        if host_id != info.host_id:
            self.db.set_host(session_string, host_id, address, port)
            log.info("session %s: host migrated to %s", session_string, host_id)
        msg = _j({
            "session_string": session_string,
            "host_id": host_id,
            "host_address": address,
            "host_port": port,
            "backup_id": backup_id,
        })
        for pid in info.participants:
            entry = self.clients.get(pid)
            if entry:
                self._signed_send(entry[0], pkt.PacketType.ACIP_HOST_DESIGNATED, msg)

    async def _run_election(self, session_string: str) -> None:
        """Centralized FALLBACK election over reported NETWORK_QUALITY
        metrics (the primary path is the participants' own ring consensus,
        whose leader announces results via ACIP_HOST_ANNOUNCEMENT)."""
        info = self.db.lookup(session_string)
        sess_metrics = self.metrics.get(session_string, {})
        if not info or not sess_metrics:
            return
        reported = [sess_metrics[p] for p in info.participants if p in sess_metrics]
        if not reported:
            return
        host_id, backup_id = cons.elect(reported)
        host_m = next(m for m in reported if m.participant_id == host_id)
        self._broadcast_host(session_string, host_id, host_m.address,
                             host_m.port, backup_id)

    async def _handle(self, t: Transport) -> None:
        peer = t.peername[0] if t.peername else "?"
        if not self.limiter.allow(peer, "connection"):
            await t.send(pkt.PacketType.ERROR_MESSAGE, _j({"error": "rate limited"}))
            return
        participant_id: str | None = None
        session_string: str | None = None
        P = pkt.PacketType
        sender_pub: bytes | None = None
        # per-connection registration nonce (anti-replay channel binding):
        # ACDS traffic is plaintext TCP, so a captured signed SESSION_JOIN
        # envelope replayed on another connection within the envelope
        # freshness window used to rebind the victim's delivery to the
        # attacker's transport. Signed registrations must echo THIS nonce.
        conn_nonce = secrets.token_hex(16)
        self._signed_send(t, P.ACIP_ACDS_HELLO, _j({"nonce": conn_nonce}))

        async def _unbind() -> None:
            """Tear down this connection's CURRENT identity binding: clients
            entry, DB membership, metrics, host failover. Used on leave, on
            re-identification (a connection switching identities must not
            orphan its old registration as a ghost member), on pin
            mismatch, and on disconnect."""
            nonlocal participant_id, session_string
            if participant_id:
                bound = self.clients.get(participant_id)
                if bound is not None and bound[0] is not t:
                    # a NEWER connection rebound this id (silent-drop then
                    # reconnect): the stale connection's teardown must not
                    # destroy the fresh binding — kicking the live client
                    # (and re-electing, if it hosts) out of its session
                    participant_id = None
                    session_string = None
                    return
                self.clients.pop(participant_id, None)
                if session_string:
                    info = self.db.lookup(session_string)
                    was_host = bool(info and info.host_id == participant_id)
                    self.db.leave(session_string, participant_id)
                    self._session_cache.pop(session_string, None)
                    self.metrics.get(session_string, {}).pop(participant_id, None)
                    await self._broadcast_participants(session_string)
                    if was_host:
                        log.info("host %s left session %s: re-electing",
                                 participant_id, session_string)
                        await self._run_election(session_string)
            participant_id = None
            session_string = None

        try:
            while True:
                ptype, payload = await t.recv()
                raw_payload = payload  # original envelope (for relaying)
                if ptype in SIGNED_RANGE:
                    # verify the Ed25519 envelope; forged/tampered payloads
                    # are dropped, an imposter re-using a known participant
                    # id with a different key is refused (first-use pinning)
                    try:
                        sender_pub, payload = ident.open_envelope(ptype, payload)
                        if participant_id is not None and ptype not in (
                                P.ACIP_SESSION_CREATE, P.ACIP_SESSION_JOIN,
                                P.ACIP_SESSION_RECONNECT):
                            # registrations may legitimately switch to a
                            # DIFFERENT identity/key (their handlers verify
                            # the NEW id's pin); gating them on the OLD
                            # binding's key made cross-key re-identification
                            # unreachable
                            self.pins.check(participant_id, sender_pub)
                    except ident.SignatureError as e:
                        log.warning("dropping unsigned/forged packet %d from %s: %s",
                                    ptype, peer, e)
                        await t.send(P.ERROR_MESSAGE, _j({"error": "bad signature"}))
                        continue
                if ptype == P.ACIP_SESSION_CREATE:
                    if not self.limiter.allow(peer, "session_create"):
                        await t.send(P.ERROR_MESSAGE, _j({"error": "rate limited"}))
                        continue
                    req = _uj(payload)
                    new_pid = req.get("participant_id") or secrets.token_hex(8)
                    if len(new_pid.encode()) > 16:
                        # the participant_metrics_t wire field is 16 bytes:
                        # a longer id would join fine yet be silently
                        # excluded from every election (its own metrics
                        # pack() raises; truncated ids fail the spoof check)
                        await t.send(P.ERROR_MESSAGE, _j(
                            {"error": "participant_id too long (max 16 bytes)"}))
                        continue
                    if not self._pin_matches(new_pid, sender_pub):
                        # VERIFY without pinning: pinning before the create
                        # validated let a failed attempt squat arbitrary ids
                        # forever (and grow the pin table without bound)
                        await t.send(P.ERROR_MESSAGE, _j({"error": "identity key mismatch"}))
                        await _unbind()
                        continue
                    if sender_pub is not None and req.get("nonce") != conn_nonce:
                        # channel binding: a replayed signed envelope carries
                        # the VICTIM's connection nonce, not this one's
                        await t.send(P.ERROR_MESSAGE, _j(
                            {"error": "stale or replayed registration"}))
                        continue
                    reserved = req.get("reserved_string")
                    if reserved:
                        # a reservation belongs to the VERIFIED identity that
                        # made it, not to whoever claims its name
                        holder = self.db.reservation_owner(reserved)
                        me = sender_pub.hex() if sender_pub else peer
                        if holder is not None and holder != me:
                            await t.send(P.ERROR_MESSAGE, _j(
                                {"error": "string reserved by another identity"}))
                            continue
                    try:
                        info = self.db.create_session(
                            new_pid, req.get("address", peer),
                            req.get("port", 27224),
                            session_string=reserved,
                            # reservations are keyed by the VERIFIED identity
                            owner_id=(sender_pub.hex() if sender_pub else peer),
                        )
                    except ValueError as e:
                        # validate BEFORE unbinding: a failed create used to
                        # evict the client from its PREVIOUS session first
                        await t.send(P.ERROR_MESSAGE, _j({"error": str(e)}))
                        continue
                    if participant_id:
                        # re-identification OR creating a new session while
                        # bound to another: either way the OLD registration
                        # must be torn down, or it lingers as a ghost
                        # member/host in the previous session
                        await _unbind()
                    participant_id = new_pid
                    self._pin(new_pid, sender_pub)  # pin only on SUCCESS
                    session_string = info.session_string
                    self._session_cache.pop(session_string, None)
                    self.clients[participant_id] = (t, session_string)
                    self._signed_send(t, P.ACIP_SESSION_CREATED, _j({
                        "session_string": info.session_string,
                        "session_id": info.session_id,
                        "participant_id": participant_id,
                    }))
                    await self._broadcast_participants(session_string)
                elif ptype == P.ACIP_SESSION_LOOKUP:
                    if not self.limiter.allow(peer, "session_lookup"):
                        await t.send(P.ERROR_MESSAGE, _j({"error": "rate limited"}))
                        continue
                    req = _uj(payload)
                    info = self.db.lookup(req["session_string"])
                    if info is None:
                        await t.send(P.ERROR_MESSAGE, _j({"error": "session not found"}))
                    else:
                        self._signed_send(t, P.ACIP_SESSION_INFO, _j({
                            "session_string": info.session_string,
                            "host_id": info.host_id,
                            "host_address": info.host_address,
                            "host_port": info.host_port,
                            "participants": info.participants,
                        }))
                elif ptype in (P.ACIP_SESSION_JOIN, P.ACIP_SESSION_RECONNECT):
                    if not self.limiter.allow(peer, "session_join"):
                        await t.send(P.ERROR_MESSAGE,
                                     _j({"error": "rate limited"}))
                        continue
                    req = _uj(payload)
                    new_pid = req.get("participant_id") or secrets.token_hex(8)
                    if len(new_pid.encode()) > 16:
                        await t.send(P.ERROR_MESSAGE, _j(
                            {"error": "participant_id too long (max 16 bytes)"}))
                        continue
                    if not self._pin_matches(new_pid, sender_pub):
                        await t.send(P.ERROR_MESSAGE, _j({"error": "identity key mismatch"}))
                        await _unbind()
                        continue
                    if sender_pub is not None and req.get("nonce") != conn_nonce:
                        await t.send(P.ERROR_MESSAGE, _j(
                            {"error": "stale or replayed registration"}))
                        continue
                    try:
                        info = self.db.join(req["session_string"], new_pid,
                                            req.get("address", peer), req.get("port", 0))
                        self._session_cache.pop(req["session_string"], None)
                    except KeyError:
                        # validate BEFORE unbinding (a failed join used to
                        # evict the client from its previous session) and
                        # never pin a failed attempt
                        await t.send(P.ERROR_MESSAGE, _j({"error": "session not found"}))
                        continue
                    if participant_id and (
                            participant_id != new_pid
                            or session_string != req.get("session_string")):
                        # re-identification or SESSION SWITCH: tear down the
                        # old binding (same-session reconnects skip this —
                        # unbinding the host there would trigger a spurious
                        # re-election)
                        await _unbind()
                    participant_id = new_pid
                    self._pin(new_pid, sender_pub)  # pin only on SUCCESS
                    session_string = info.session_string
                    self.clients[participant_id] = (t, session_string)
                    self._signed_send(t, P.ACIP_SESSION_JOINED, _j({
                        "session_string": info.session_string,
                        "participant_id": participant_id,
                        "host_id": info.host_id,
                        "host_address": info.host_address,
                        "host_port": info.host_port,
                    }))
                    await self._broadcast_participants(session_string)
                elif ptype == P.ACIP_SESSION_LEAVE:
                    # the FULL unbind: a departed participant must lose its
                    # relay/election/settings access to the session, not
                    # just its row in the participant list
                    await _unbind()
                elif ptype == P.ACIP_SESSION_END:
                    if participant_id and session_string:
                        ended = session_string
                        # end_session is HOST-authenticated (WHERE host_id):
                        # ignoring its result let any participant wipe the
                        # session's election metrics and linger in the DB as
                        # a ghost member (its local unbind skipped db.leave)
                        if self.db.end_session(ended, participant_id):
                            self.metrics.pop(ended, None)
                            self._session_cache.pop(ended, None)
                            self.clients.pop(participant_id, None)
                            participant_id = None
                            session_string = None
                        else:
                            # non-host END degrades to a clean LEAVE
                            log.warning("SESSION_END from non-host %s "
                                        "treated as leave", participant_id)
                            await _unbind()
                elif ptype in (P.ACIP_STRING_RESERVE, P.ACIP_STRING_RENEW,
                               P.ACIP_STRING_RELEASE):
                    # limit BEFORE parsing (every other handler's order): a
                    # flood of 5 MB JSON bodies otherwise pays a multi-MB
                    # json.loads per packet after the budget is exhausted
                    if not self.limiter.allow(peer, "string_reserve"):
                        await t.send(P.ERROR_MESSAGE, _j({"error": "rate limited"}))
                        continue
                    req = _uj(payload)
                    # ownership is the VERIFIED identity key, never a
                    # claimed owner_id: every participant_id is public (it
                    # rides every ACIP_PARTICIPANT_LIST), so claim-based
                    # matching would let anyone release/renew/hijack another
                    # party's reserved session name
                    owner = sender_pub.hex() if sender_pub else req.get(
                        "owner_id", peer)
                    if ptype == P.ACIP_STRING_RESERVE:
                        ok = self.db.reserve_string(req["session_string"], owner)
                        self._signed_send(t, P.ACIP_STRING_RESERVED, _j({"ok": ok}))
                    elif ptype == P.ACIP_STRING_RENEW:
                        self.db.renew_string(req["session_string"], owner)
                    else:
                        self.db.release_string(req["session_string"], owner)
                elif ptype == P.ACIP_NETWORK_QUALITY:
                    m = cons.ParticipantMetrics.unpack(payload)
                    if m.participant_id != participant_id:
                        log.warning("metrics id-spoof dropped: %s claimed by %s",
                                    m.participant_id, participant_id)
                    elif session_string:
                        # membership re-checked: a stale binding (session
                        # ended, string recreated) must not inject metrics
                        # into the successor session's elections
                        info = self._session_info_cached(session_string)
                        if info and participant_id in info.participants:
                            self.metrics.setdefault(
                                session_string, {})[m.participant_id] = m
                elif ptype == P.ACIP_HOST_ANNOUNCEMENT:
                    # rate-limited: the empty-body form fans out to a full
                    # election (2 DB lookups + a signed broadcast to every
                    # member) per packet — unmetered, one client could
                    # saturate a large session's control plane
                    if not self.limiter.allow(peer, "host_announce"):
                        await t.send(P.ERROR_MESSAGE,
                                     _j({"error": "rate limited"}))
                        continue
                    if session_string:
                        req = {}
                        if payload:
                            try:
                                req = _uj(payload)
                            except ValueError:
                                pass
                        if "host_id" in req:
                            # ring-elected result: adopt ONLY from the ring
                            # LEADER (deterministic: lexicographically last
                            # participant) — any other participant announcing
                            # a host is a hijack attempt and is refused
                            # (participants separately re-verify elections,
                            # RingRunner.on_election_result)
                            info = self.db.lookup(session_string)
                            leader = (cons.ring_order(info.participants)[-1]
                                      if info and info.participants else None)
                            if participant_id != leader:
                                log.warning(
                                    "host announcement from non-leader %s "
                                    "refused (leader: %s)", participant_id, leader)
                                continue
                            if req["host_id"] not in info.participants:
                                log.warning("announced host %s is not a "
                                            "participant; refused", req["host_id"])
                                continue
                            if not req.get("host_address"):
                                # defaulting to the ANNOUNCER's IP recorded a
                                # wrong address for a DIFFERENT host — every
                                # later lookup/join then dialed the leader
                                log.warning("host announcement without "
                                            "host_address refused")
                                continue
                            self._broadcast_host(
                                session_string, req["host_id"],
                                req["host_address"],
                                int(req.get("host_port", 0)),
                                req.get("backup_id"),
                            )
                        else:
                            # stale-binding guard (same as metrics/relay): a
                            # ghost whose session ended and whose string was
                            # recreated by strangers must not trigger
                            # elections in the successor session
                            info = self._session_info_cached(session_string)
                            if (info is None
                                    or participant_id not in info.participants):
                                continue
                            await self._run_election(session_string)
                elif ptype in (P.ACIP_WEBRTC_SDP, P.ACIP_WEBRTC_ICE,
                               P.ACIP_WEBRTC_RELAY, P.ACIP_RING_COLLECT,
                               P.ACIP_SETTINGS_SYNC, P.ACIP_SETTINGS_ACK):
                    # relay to target participant (signaling.c:137 pattern);
                    # the ORIGINAL sender-signed envelope travels end-to-end
                    # so the receiver verifies the sender, not the relay
                    if not participant_id or not session_string:
                        continue  # must have joined a session to relay
                    req = _uj(payload)
                    claimed_from = req.get("from", "")
                    # a connection may only speak AS ITSELF: pinning the
                    # claimed id on first use would let anyone squat a
                    # not-yet-joined participant's identity
                    if claimed_from != participant_id:
                        log.warning("relay from-spoof dropped: %s claimed by %s",
                                    claimed_from, participant_id)
                        continue
                    try:
                        self.pins.check(claimed_from, sender_pub)
                    except ident.SignatureError:
                        log.warning("relay key mismatch for %s", claimed_from)
                        continue
                    # the bandwidth budget covers EVERY blind-forwarded
                    # type: metering only ACIP_WEBRTC_RELAY let colluders
                    # tunnel unlimited bulk data in SDP/ICE/RING/SETTINGS
                    # bodies — the exact amplifier abuse the budget exists
                    # to stop (signaling is tiny, so the budget is
                    # invisible to legitimate use)
                    budget_key = (sender_pub.hex() if sender_pub
                                  else f"ip:{peer}")
                    # keyed by the PINNED KEY (fallback: peer IP), never the
                    # rebindable participant_id — cycling ids granted a
                    # fresh burst per join
                    if not self.relay_budget.allow(budget_key,
                                                   len(raw_payload)):
                        self.relay_dropped += 1
                        if self.relay_dropped % 500 == 1:
                            log.warning("relay budget exceeded by %s "
                                        "(%d dropped total)",
                                        participant_id, self.relay_dropped)
                        continue
                    # targets are restricted to the SENDER'S OWN session —
                    # the relay must not bridge unrelated sessions
                    to_id = req.get("to", "")
                    info = self._session_info_cached(session_string)
                    # the SENDER must still be a member too: a stale
                    # binding (its session ended, the string recreated by
                    # strangers) would otherwise let a ghost signal/relay
                    # into — and keep alive — a session it never joined
                    if (info is None or participant_id not in info.participants
                            or to_id not in info.participants):
                        continue
                    # relayed session traffic is liveness: refresh the
                    # inactivity clock (database.c:871 role) so an active
                    # call never idle-expires mid-session. Throttled: an
                    # UPDATE+fsync per relayed media segment would melt a
                    # file-backed DB on the relay hot path.
                    self._touch_throttled(session_string)
                    target = self.clients.get(to_id)
                    if target:
                        target[0].send_nowait(ptype, raw_payload)
                elif ptype == P.PING:
                    await t.send(P.PONG, payload)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        except Exception:
            # handler bodies parse client-controlled JSON/structs: a shape we
            # did not anticipate (TypeError/KeyError/AttributeError/...) must
            # drop THIS connection, not surface as an unhandled task error
            log.exception("acds connection %s dropped on malformed input", peer)
        finally:
            # host failover on disconnect rides the same unbind path
            # (backup promotion: _run_election among the remaining members)
            await _unbind()

    async def _election_loop(self) -> None:
        while True:
            await asyncio.sleep(self.election_interval)
            try:
                for s in list(self.metrics):
                    if self.db.lookup(s) is None:
                        # ended/expired session: evict, or a long-lived
                        # public ACDS accumulates a metrics dict (and a
                        # per-cycle DB lookup here) for every session it
                        # EVER served
                        self.metrics.pop(s, None)
                        continue
                    await self._run_election(s)
            except Exception:
                # a transient DB error (e.g. locked file) must not silently
                # kill the periodic fallback-election task for the rest of
                # the server's life — the exception would never surface
                log.exception("election loop cycle failed; continuing")

    async def run(self) -> None:
        server = await serve_tcp(self._handle, self.host, self.port)
        log.info("ACDS listening on %s:%d", self.host, self.port)
        loop_task = asyncio.get_running_loop().create_task(self._election_loop())
        try:
            await server.serve_forever()
        finally:
            loop_task.cancel()


def main(args) -> int:
    server = AcdsServer(args.host, args.port, db_path=args.db)
    try:
        asyncio.run(server.run())
    except KeyboardInterrupt:
        pass
    return 0
