"""Ring consensus: distributed host election state machines.

Re-derivation of docs/ring-consensus-protocol.md +
lib/network/consensus/{election,topology,state}.c:

- ring order: participant IDs sorted lexicographically; leader is the LAST
  participant (ring-consensus-protocol.md "Ring Leader")
- metrics: NAT tier / upload kbps / RTT / STUN success per participant
- score:  (4 - nat_tier)*1000 + upload_kbps/10 + max(0, 500 - rtt_ms)
          + stun_success_pct  (election.c:13-36, exact integer math)
- election: best score = host, second best = backup, first-wins ties
  (find_best_two, election.c:39-66)
- collection round: leader starts, metrics accumulate around the ring,
  leader computes + announces; reformation on join/leave.

The state machines are transport-agnostic (emit/consume message dicts) so
they run in-process for tests (the reference's consensus e2e strategy,
tests/integration/network/consensus/test_consensus_e2e.c) and over ACIP
packets in discovery mode.

The port's copy of ``asciichat_tpu/net/consensus.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import time


@dataclasses.dataclass(frozen=True)
class ParticipantMetrics:
    """participant_metrics_t (ring-consensus-protocol.md wire struct)."""

    participant_id: str
    nat_tier: int = 1  # 0=LAN 1=Public 2=UPnP 3=STUN 4=TURN
    upload_kbps: int = 10_000
    rtt_ms: int = 50
    stun_success_pct: int = 100
    address: str = ""
    port: int = 0
    measured_at_ms: int = 0

    STRUCT = struct.Struct(">16sBIHB64sHQ")

    def pack(self) -> bytes:
        pid = self.participant_id.encode()
        if len(pid) > 16:
            # silent truncation would round-trip to a DIFFERENT id, breaking
            # the ACDS spoof check and ring host lookups — fail loudly
            raise ValueError(
                f"participant_id {self.participant_id!r} exceeds the 16-byte "
                "participant_metrics_t field")
        addr = self.address.encode()
        if len(addr) > 64:
            # silent truncation could cut mid-UTF-8 (unpack then raises on
            # every ring message carrying the entry — permanent consensus
            # failure) or adopt a nonexistent host address — fail loudly
            raise ValueError(
                f"address {self.address!r} exceeds the 64-byte "
                "participant_metrics_t field")
        return self.STRUCT.pack(
            pid.ljust(16, b"\0"),
            self.nat_tier, self.upload_kbps, self.rtt_ms, self.stun_success_pct,
            addr, self.port,
            self.measured_at_ms or int(time.time() * 1000),
        )

    @staticmethod
    def unpack(buf: bytes) -> "ParticipantMetrics":
        try:
            pid, nat, up, rtt, stun, addr, port, ts = (
                ParticipantMetrics.STRUCT.unpack(
                    buf[: ParticipantMetrics.STRUCT.size]))
        except struct.error as e:
            # struct.error is NOT a ValueError: peers' malformed metrics must
            # surface as the bad-data contract, not kill event loops
            raise ValueError(f"short participant metrics: {e}") from e
        return ParticipantMetrics(
            participant_id=pid.rstrip(b"\0").decode(),
            nat_tier=nat, upload_kbps=up, rtt_ms=rtt, stun_success_pct=stun,
            address=addr.split(b"\0")[0].decode(), port=port, measured_at_ms=ts,
        )


def compute_score(m: ParticipantMetrics) -> int:
    """Deterministic score (consensus_election_compute_score, election.c:13-36)."""
    nat_score = (4 - m.nat_tier) * 1000
    bw_score = m.upload_kbps // 10
    rtt_score = (500 - m.rtt_ms) if m.rtt_ms < 500 else 0
    return nat_score + bw_score + rtt_score + m.stun_success_pct


def elect(metrics: list[ParticipantMetrics]) -> tuple[str, str]:
    """-> (host_id, backup_id); first-wins ties (find_best_two, election.c:39-66)."""
    if not metrics:
        raise ValueError("no participants")
    scores = [compute_score(m) for m in metrics]
    best, second = 0, 1 if len(scores) > 1 else 0
    if len(scores) > 1 and scores[1] > scores[0]:
        best, second = 1, 0
    for i in range(2, len(scores)):
        if scores[i] > scores[best]:
            second = best
            best = i
        elif scores[i] > scores[second]:
            second = i
    return metrics[best].participant_id, metrics[second].participant_id


def elect_sticky(metrics: list[ParticipantMetrics],
                 prev_host: str | None) -> tuple[str, str]:
    """elect() with incumbent hysteresis: the CURRENT host wins EXACT score
    ties (the challenger becomes backup). Without real differentiating
    measurements every participant ties, and first-wins picked whichever
    entry the leader collected first — a gratuitous host migration (stream
    interruption for every viewer) one collection interval into every
    session. Deviation from find_best_two is deliberate and tie-only."""
    host, backup = elect(metrics)
    if prev_host and prev_host != host:
        scores = {m.participant_id: compute_score(m) for m in metrics}
        if prev_host in scores and scores[prev_host] == scores[host]:
            return prev_host, host
    return host, backup


def ring_order(participant_ids: list[str]) -> list[str]:
    """Deterministic ring: IDs sorted lexicographically."""
    return sorted(participant_ids)


@dataclasses.dataclass
class RingPosition:
    position: int
    next_id: str
    prev_id: str
    is_leader: bool


def ring_positions(participant_ids: list[str]) -> dict[str, RingPosition]:
    """RING_MEMBERS content: everyone can compute the same layout."""
    order = ring_order(participant_ids)
    n = len(order)
    return {
        pid: RingPosition(
            position=i,
            next_id=order[(i + 1) % n],
            prev_id=order[(i - 1) % n],
            is_leader=(i == n - 1),
        )
        for i, pid in enumerate(order)
    }


class Phase(enum.Enum):
    IDLE = "idle"
    COLLECTING = "collecting"
    DECIDED = "decided"


class ConsensusParticipant:
    """One participant's consensus state machine.

    Drive with: on_ring_members(), start_collection() (leader only),
    on_stats_update(), on_election_result(). Outgoing messages are returned
    as (to_participant_id_or_None_for_broadcast, message_dict).
    """

    def __init__(self, my_id: str, metrics_provider=None,
                 entry_signer=None, entry_verifier=None):
        self.my_id = my_id
        self.metrics_provider = metrics_provider or (
            lambda: ParticipantMetrics(participant_id=self.my_id)
        )
        # Per-entry metric signatures (optional, wired by RingRunner):
        # entry_signer(m, rid) -> sig over be32(rid)||m.pack();
        # entry_verifier(m, sig, rid) — binding the ROUND ID prevents a
        # malicious leader replaying other members' previously-signed
        # entries under a fresh round_id (stale addresses/metrics that
        # honest verifiers would re-accept)
        # -> bool. Without them a malicious ring LEADER can forge every
        # OTHER participant's metric values in a result that verifiers then
        # accept (the recompute matches the forged inputs); with them each
        # entry is bound to its owner's pinned Ed25519 key, so a leader —
        # including one that grabbed leadership with a lexicographically-
        # last self-chosen id — can only lie about its OWN metrics.
        self.entry_signer = entry_signer
        self.entry_verifier = entry_verifier
        self.positions: dict[str, RingPosition] = {}
        self.phase = Phase.IDLE
        self.round_id = 0
        self.host_id: str | None = None
        self.backup_id: str | None = None

    def _my_entry(self, rid: int) -> tuple[ParticipantMetrics, bytes | None]:
        m = self.metrics_provider()
        if not m.measured_at_ms:
            # pin the timestamp NOW: pack() stamps lazily, so a signature
            # over pack() would not match a later re-pack of the same entry
            m = dataclasses.replace(
                m, measured_at_ms=int(time.time() * 1000))
        sig = self.entry_signer(m, rid) if self.entry_signer else None
        return m, sig

    def _entries_verify(self, metrics: list[ParticipantMetrics],
                        sigs, rid: int) -> bool:
        if self.entry_verifier is None:
            return True
        if not isinstance(sigs, list) or len(sigs) != len(metrics):
            sigs = [None] * len(metrics)
        return all(self.entry_verifier(m, s, rid)
                   for m, s in zip(metrics, sigs))

    @property
    def is_leader(self) -> bool:
        pos = self.positions.get(self.my_id)
        return bool(pos and pos.is_leader)

    def on_ring_members(self, participant_ids: list[str]) -> None:
        """Phase 1: ring (re)formation on join/leave. Reformation starts a
        new round EPOCH: the replay floor resets, because a new leader
        numbers its rounds from 1 and must not be locked out by the old
        leader's higher counter. The exact-membership check rejects
        cross-epoch replays for CHANGED memberships; a recurring membership
        (leave + fast rejoin) is covered by the per-entry measured_at
        freshness bound RingRunner._verify_entry enforces — a replayed
        result's entries age out within ~2 collection intervals."""
        self.positions = ring_positions(participant_ids)
        self.phase = Phase.IDLE
        self.round_id = 0

    def start_collection(self) -> tuple[str, dict]:
        """Phase 2 kick-off: the leader measures and forwards to its NEXT
        participant (collection flows around the ring back to the leader)."""
        assert self.is_leader, "only the ring leader starts collection"
        self.round_id += 1
        self.phase = Phase.COLLECTING
        me, sig = self._my_entry(self.round_id)
        msg = {
            "type": "STATS_UPDATE",
            "round_id": self.round_id,
            "metrics": [me],
            "sigs": [sig],
        }
        return self.positions[self.my_id].next_id, msg

    def on_stats_update(self, msg: dict,
                        sender: str | None = None) -> tuple[str | None, dict] | None:
        """Append own metrics and forward; the leader closes the loop by
        electing and broadcasting RING_ELECTION_RESULT.

        Validated before ANY state changes (None = drop silently):

        - `sender` (the signed-relay envelope 'from', when provided) must
          be OUR ring predecessor — collection flows around the ring in
          order, so a member that relays a STATS_UPDATE straight to the
          leader with a fabricated complete metrics list cannot have the
          leader elect from 100% attacker-chosen data;
        - round_id must be a positive int (a non-int would lodge in state
          and make later comparisons raise);
        - metrics entries must be current ring members with no duplicates;
        - the leader only closes a loop it OPENED: phase COLLECTING and
          the round id it assigned in start_collection.

        The replay floor (self.round_id) is deliberately NOT adopted from
        forwarded updates: only rounds we start or results we accept move
        it, so a forged huge round_id cannot poison the floor and lock out
        every future genuine result."""
        if not self.positions or self.my_id not in self.positions:
            return None
        if sender is not None and sender != self.positions[self.my_id].prev_id:
            return None
        rid = msg.get("round_id")
        if not isinstance(rid, int) or rid <= 0:
            return None
        metrics: list[ParticipantMetrics] = list(msg.get("metrics") or [])
        ids = [m.participant_id for m in metrics]
        if not metrics or len(set(ids)) != len(ids) or not (
                set(ids) <= set(self.positions)):
            return None
        sigs = msg.get("sigs")
        sigs = list(sigs) if isinstance(sigs, list) and len(sigs) == len(
            metrics) else [None] * len(metrics)
        if not self._entries_verify(metrics, sigs, rid):
            return None  # an entry not signed by its owner's pinned key
        if any(m.participant_id == self.my_id for m in metrics):
            # collection returned to the leader: everyone measured
            if not self.is_leader:
                return None
            if self.phase != Phase.COLLECTING or rid != self.round_id:
                return None  # a round we never started
            if set(ids) != set(self.positions):
                # EXACT coverage to close, mirroring on_election_result: a
                # predecessor that stripped members would otherwise have
                # the leader elect from a shrunken electorate — a result
                # every honest member then rejects (split-brain that the
                # ACDS, trusting the leader, would ratify)
                return None
            # incumbent hysteresis: exact-tie scores keep the current host
            host, backup = elect_sticky(metrics, self.host_id)
            prev_host = self.host_id
            self.host_id, self.backup_id = host, backup
            self.phase = Phase.DECIDED
            return None, {
                "type": "RING_ELECTION_RESULT",
                "round_id": rid,
                "host_id": host,
                "backup_id": backup,
                "prev_host_id": prev_host,
                "metrics": metrics,
                "sigs": sigs,
            }
        me, sig = self._my_entry(rid)
        return (
            self.positions[self.my_id].next_id,
            {"type": "STATS_UPDATE", "round_id": rid,
             "metrics": metrics + [me], "sigs": sigs + [sig]},
        )

    def on_election_result(self, msg: dict, sender: str | None = None) -> dict:
        """Phase 4: verify + ack. A result is only ACCEPTED when ALL hold:

        - the sender (outer signed-relay envelope 'from') IS the current
          deterministic ring leader — non-leaders cannot announce results;
        - the included metrics cover EXACTLY the ring membership — an
          attacker cannot shrink the electorate to just itself;
        - round_id is not older than the newest round we've seen — a
          replayed genuinely-signed result from an earlier membership is
          rejected;
        - the recomputed election over those metrics matches the claim.

        With entry_signer/entry_verifier wired (RingRunner does), each
        metrics entry is additionally bound to its owner's pinned Ed25519
        key, so a malicious leader — including one that grabbed the
        deterministic leadership with a lexicographically-last self-chosen
        id — can only misreport its OWN metrics. (The reference protocol
        accepts leader-reported values unsigned; this is a hardening on
        top of it.)"""
        leader = next(
            (pid for pid, p in self.positions.items() if p.is_leader), None)
        rid = msg.get("round_id")
        ok = isinstance(rid, int) and rid > 0
        if ok:
            ok = self.positions != {} and (sender is None or sender == leader)
        if ok:
            ids = sorted(m.participant_id for m in msg.get("metrics") or [])
            ok = bool(ids) and ids == ring_order(list(self.positions))
        if ok:
            ok = rid >= self.round_id
        if ok:
            # per-entry ownership: each metrics entry must carry its
            # owner's signature (when verification is wired) — a malicious
            # leader can then only misreport its OWN metrics
            ok = self._entries_verify(list(msg["metrics"]), msg.get("sigs"),
                                      rid)
        if ok:
            # the leader's claimed incumbent must be a ring member; the
            # sticky recompute is otherwise attacker-steerable only on
            # EXACT ties (equal fitness)
            prev = msg.get("prev_host_id")
            if prev not in self.positions:
                prev = None
            host, backup = elect_sticky(msg["metrics"], prev)
            ok = host == msg.get("host_id") and backup == msg.get("backup_id")
        if ok:
            self.host_id = msg["host_id"]
            self.backup_id = msg["backup_id"]
            self.round_id = max(self.round_id, rid)
            self.phase = Phase.DECIDED
        return {
            "type": "STATS_ACK",
            # validated-or-missing: a result without round_id must produce
            # a REJECTED ack, not a KeyError after state already mutated
            "round_id": rid if isinstance(rid, int) else 0,
            "participant_id": self.my_id,
            "ack_status": "ACCEPTED" if ok else "REJECTED",
            "stored_host_id": self.host_id,
        }

    def on_host_lost(self) -> str | None:
        """Failover: promote the backup immediately (host failover path)."""
        if self.backup_id and self.backup_id != self.host_id:
            self.host_id = self.backup_id
            self.backup_id = None
            return self.host_id
        return None
