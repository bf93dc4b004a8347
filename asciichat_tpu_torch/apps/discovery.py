"""Discovery mode: P2P sessions with automatic host negotiation + failover.

Parity with src/discovery/ + src/common/session/{host,participant}.c and the
host-failover path (ring-consensus election of host+backup,
docs/ring-consensus-protocol.md): every participant runs a STANDBY chat
server on its own port and reports NETWORK_QUALITY metrics advertising it;
the ACDS designates the host (initially the session creator). When the host
drops, the ACDS immediately re-elects among the remaining participants and
broadcasts HOST_DESIGNATED — every participant's viewer migrates to the new
host by reconnecting, so the session survives the host's death.

The port's copy of ``asciichat_tpu/apps/discovery.py``: the standby server
is the port's ``AsciiChatServer``, whose tick (K3, K4) runs on
``runtime/device.default_device()``, and the viewer is the port's client.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import secrets
import time

from asciichat_tpu_torch.net import consensus as cons
from asciichat_tpu_torch.net import identity as ident
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net.transport import connect_tcp
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("discovery")

from asciichat_tpu_torch.net.packet import ACDS_SIGNED_RANGE as SIGNED_RANGE  # noqa: E501 — one protocol ground truth


class SignedAcdsChannel:
    """Transport wrapper: signs outgoing ACDS subprotocol payloads with this
    participant's Ed25519 identity and verifies incoming ones — service
    packets against the TOFU-pinned ACDS key, relayed peer packets
    (ring/SDP/ICE, which travel sender-signed end-to-end through the relay)
    against the sender's pinned key. Forged or tampered packets are DROPPED
    (the reference rejects unsigned ACDS structs, acds.h)."""

    ACDS_NAME = "@acds"

    def __init__(self, t, identity: ident.Identity, pins: ident.KnownPeers):
        self.t = t
        self.identity = identity
        self.pins = pins
        P = pkt.PacketType
        self._relayed = {P.ACIP_RING_COLLECT, P.ACIP_WEBRTC_SDP,
                         P.ACIP_WEBRTC_ICE, P.ACIP_WEBRTC_RELAY,
                         P.ACIP_SETTINGS_SYNC, P.ACIP_SETTINGS_ACK}
        self.dropped = 0

    async def send(self, ptype: int, payload: bytes = b"") -> None:
        if ptype in SIGNED_RANGE:
            payload = self.identity.sign(ptype, payload)
        await self.t.send(ptype, payload)

    def send_nowait(self, ptype: int, payload: bytes = b"") -> bool:
        if ptype in SIGNED_RANGE:
            payload = self.identity.sign(ptype, payload)
        return self.t.send_nowait(ptype, payload)

    async def recv(self) -> tuple[int, bytes]:
        while True:
            ptype, payload = await self.t.recv()
            if ptype in SIGNED_RANGE:
                try:
                    pub, body = ident.open_envelope(ptype, payload)
                    if ptype in self._relayed:
                        # relayed peers must ALREADY be pinned (keys arrive
                        # via the ACDS-signed participant list) — first-use
                        # pinning here would let any ACDS client squat a
                        # session peer's identity by racing that list
                        self.pins.require(json.loads(body).get("from", ""), pub)
                    else:
                        self.pins.check(self.ACDS_NAME, pub)
                except (ident.SignatureError, ValueError) as e:
                    self.dropped += 1
                    log.warning("dropped forged/unverifiable packet %d: %s", ptype, e)
                    continue
                payload = body
            return ptype, payload

    async def close(self) -> None:
        await self.t.close()

    @property
    def peername(self):
        return self.t.peername

QUALITY_REPORT_INTERVAL_S = 30.0
RING_COLLECTION_INTERVAL_S = 60.0  # periodic ring rounds (consensus docs: 5 min)


async def measure_stun_success(server: tuple[str, int], n: int = 5,
                               timeout: float = 0.5,
                               ) -> tuple[int, tuple[str, int] | None]:
    """Send n REAL RFC 5389 binding requests and count answers.

    Returns (success_pct, last XOR-mapped address or None). This is the
    probing the reference's measure_stun_probe_success() documents but
    stubs at a literal 90 (lib/network/consensus/metrics.c:49-57)."""
    from asciichat_tpu_torch.net import stun

    loop = asyncio.get_running_loop()

    class _Proto(asyncio.DatagramProtocol):
        def __init__(self):
            self.fut: asyncio.Future | None = None

        def datagram_received(self, data, addr):
            if self.fut is not None and not self.fut.done():
                self.fut.set_result(data)

        def error_received(self, exc):  # ICMP unreachable etc.
            if self.fut is not None and not self.fut.done():
                self.fut.set_exception(ConnectionError(str(exc)))

    try:
        transport, proto = await loop.create_datagram_endpoint(
            _Proto, remote_addr=server)
    except OSError:
        return 0, None
    ok = 0
    mapped: tuple[str, int] | None = None
    try:
        for _ in range(n):
            txid = stun.new_transaction_id()
            proto.fut = loop.create_future()
            transport.sendto(stun.build(0x0001, txid, []))
            try:
                data = await asyncio.wait_for(proto.fut, timeout)
                mtype, rtx, attrs = stun.parse(data)
                if mtype == 0x0101 and rtx == txid:
                    ok += 1
                    val = attrs.get(0x0020)  # XOR-MAPPED-ADDRESS
                    if val is not None:
                        mapped = stun.parse_xor_mapped_address(val)
            except (asyncio.TimeoutError, ConnectionError, stun.StunError):
                pass
    finally:
        transport.close()
    return ok * 100 // n, mapped


def _encode_ring_msg(msg: dict) -> dict:
    """Ring messages travel as JSON with hex-packed participant_metrics_t
    entries (the reference packs the same struct into STATS_UPDATE,
    docs/ring-consensus-protocol.md wire formats)."""
    out = dict(msg)
    if "metrics" in out:
        out["metrics"] = [m.pack().hex() for m in out["metrics"]]
    if "sigs" in out:
        out["sigs"] = [s.hex() if s else None for s in out["sigs"]]
    return out


def _decode_ring_msg(msg: dict) -> dict:
    out = dict(msg)
    if "metrics" in out:
        out["metrics"] = [
            cons.ParticipantMetrics.unpack(bytes.fromhex(h)) for h in out["metrics"]
        ]
    if "sigs" in out:
        out["sigs"] = [bytes.fromhex(s) if s else None for s in out["sigs"]]
    return out


class RingRunner:
    """Drives the ring-consensus state machine (net/consensus.py) over live
    ACIP: ring messages are relayed participant-to-participant through the
    ACDS (ACIP_RING_COLLECT, the signaling.c:137 relay pattern — the P2P mesh
    may not exist yet when consensus runs). The centralized ACDS election
    stays as the fallback when the ring path fails.

    Counterpart of lib/network/consensus/{coordinator,election}.c +
    docs/ring-consensus-protocol.md: the leader starts a collection round,
    STATS_UPDATE accumulates metrics around the ring, the leader elects and
    broadcasts RING_ELECTION_RESULT, every participant RE-VERIFIES the
    election from the included metrics and rejects a forged result.
    """

    # domain constant binding per-entry metric signatures (distinct from
    # any real packet type's envelope so one can't be replayed as the other)
    METRICS_ENTRY_PTYPE = 6999

    def __init__(self, sess: "DiscoverySession",
                 interval_s: float = RING_COLLECTION_INTERVAL_S):
        self.sess = sess
        self.cp = cons.ConsensusParticipant(
            sess.participant_id, sess.metrics,
            entry_signer=self._sign_entry,
            entry_verifier=self._verify_entry)
        self.interval = interval_s
        self.rounds_completed = 0
        self.results_verified = 0
        self.results_rejected = 0

    def _sign_entry(self, m: cons.ParticipantMetrics, rid: int) -> bytes:
        """Bind our metrics entry to our Ed25519 identity AND the round it
        was measured for: without the identity a malicious ring leader can
        forge every OTHER member's values; without the ROUND binding it can
        replay members' previously-signed entries under a fresh round_id
        (stale addresses honest verifiers would re-adopt)."""
        import struct as _struct

        return self.sess.identity.sign(
            self.METRICS_ENTRY_PTYPE, _struct.pack(">I", rid) + m.pack())

    # entries older than this are stale regardless of envelope freshness:
    # the backstop against replaying a whole captured result (same ring,
    # post-reformation floor reset) — ~2 collection intervals + skew
    ENTRY_MAX_AGE_S = 2 * RING_COLLECTION_INTERVAL_S + 30

    def _verify_entry(self, m: cons.ParticipantMetrics,
                      sig: bytes | None, rid: int) -> bool:
        import struct as _struct
        import time as _time

        now_ms = _time.time() * 1000
        if m.measured_at_ms and (
                m.measured_at_ms < now_ms - self.ENTRY_MAX_AGE_S * 1000
                or m.measured_at_ms > now_ms + 30_000):
            return False  # stale (replayed round) or future-dated entry
        pinned = self.sess.pins.get(m.participant_id)
        if m.participant_id == self.sess.participant_id:
            pinned = self.sess.identity.public_bytes  # my own entry: my key
        if sig is None:
            # unsigned entries are tolerated ONLY while the owner's key is
            # unknown (bootstrap before the first ACDS participant list)
            return pinned is None
        try:
            pub, body = ident.open_envelope(self.METRICS_ENTRY_PTYPE, sig)
        except ident.SignatureError:
            return False
        if body != _struct.pack(">I", rid) + m.pack():
            return False  # different values OR a different round's entry
        return pinned is None or pub == pinned

    # -- wiring -------------------------------------------------------------
    def _send(self, to_pid: str, msg: dict) -> None:
        self.sess._t.send_nowait(pkt.PacketType.ACIP_RING_COLLECT, json.dumps({
            "to": to_pid,
            "from": self.sess.participant_id,
            "msg": _encode_ring_msg(msg),
        }).encode())

    def on_members(self, participant_ids: list[str]) -> None:
        self.cp.on_ring_members(participant_ids)

    async def leader_loop(self) -> None:
        """The ring leader starts a collection round every interval."""
        while True:
            await asyncio.sleep(self.interval)
            self.start_round_if_leader()

    def start_round_if_leader(self) -> bool:
        if not self.cp.is_leader or len(self.cp.positions) < 2:
            return False
        to_pid, msg = self.cp.start_collection()
        self._send(to_pid, msg)
        return True

    # -- message handling ----------------------------------------------------
    def on_ring_packet(self, payload: bytes) -> None:
        data = json.loads(payload)
        msg = _decode_ring_msg(data["msg"])
        mtype = msg.get("type")
        if mtype == "STATS_UPDATE":
            # the envelope 'from' is pin-verified by SignedAcdsChannel; the
            # state machine additionally requires it to be our predecessor
            out = self.cp.on_stats_update(msg, sender=data.get("from"))
            if out is None:
                return
            to_pid, next_msg = out
            if to_pid is None:
                # collection closed the loop: we are the leader with a result
                self.rounds_completed += 1
                for p in self.cp.positions:
                    if p != self.cp.my_id:
                        self._send(p, next_msg)
                self._apply_result(next_msg, announce=True)
            else:
                self._send(to_pid, next_msg)
        elif mtype == "RING_ELECTION_RESULT":
            # the outer envelope 'from' is verified against the sender's
            # pinned key by SignedAcdsChannel; the state machine additionally
            # requires it to BE the deterministic ring leader
            ack = self.cp.on_election_result(msg, sender=data.get("from"))
            if ack["ack_status"] == "ACCEPTED":
                self.results_verified += 1
                self._apply_result(msg, announce=False)
            else:
                self.results_rejected += 1
                log.warning(
                    "rejected RING_ELECTION_RESULT claiming host=%s (recomputed "
                    "election disagrees — forged or stale)", msg.get("host_id"),
                )
            self._send(data.get("from", ""), ack)
        elif mtype == "STATS_ACK":
            if msg.get("ack_status") == "REJECTED":
                log.warning("participant %s rejected our election result",
                            msg.get("participant_id"))

    def _apply_result(self, msg: dict, announce: bool) -> None:
        """Adopt a VERIFIED election result; the leader also announces it to
        the ACDS so the session DB (late joiners) stays consistent."""
        host_id = msg["host_id"]
        host_m = next(
            (m for m in msg["metrics"] if m.participant_id == host_id), None
        )
        if host_m is None:
            return
        sess = self.sess
        if announce:
            sess._t.send_nowait(pkt.PacketType.ACIP_HOST_ANNOUNCEMENT, json.dumps({
                "session_string": sess.session_string,
                "host_id": host_id,
                "host_address": host_m.address,
                "host_port": host_m.port,
                "backup_id": msg.get("backup_id"),
            }).encode())
        if host_id != sess.host_id:
            sess.host_id = host_id
            sess.host_address = host_m.address
            sess.host_port = host_m.port
            log.info("ring consensus: host is now %s (%s:%d)",
                     host_id, host_m.address, host_m.port)
            if sess.on_host_changed:
                sess.on_host_changed(host_m.address, host_m.port)


class _OfferGlare(Exception):
    """Simultaneous p2p_connect offers; the lower id yields (see
    _p2p_answer) and its p2p_connect delegates to p2p_accept."""


class DiscoverySession:
    """ACDS-side participation: register, report metrics, track the host."""

    def __init__(self, acds_host: str, acds_port: int,
                 participant_id: str | None = None):
        self.acds_host = acds_host
        self.acds_port = acds_port
        self.participant_id = participant_id or secrets.token_hex(8)
        self.session_string: str | None = None
        self.host_id: str | None = None
        self.host_address: str | None = None
        self.host_port: int | None = None
        # this participant's own standby-server contact info (advertised in
        # NETWORK_QUALITY so elections can designate us)
        self.my_address: str = "127.0.0.1"
        self.my_port: int = 0
        self.participants: list[str] = []
        self.on_host_changed = None  # callback(address, port)
        self.ring: RingRunner | None = None  # attach_ring() enables P2P consensus
        self.identity = ident.Identity()
        self.pins = ident.KnownPeers()
        # P2P channels (net/webrtc.py): ICE-lite agents negotiated through
        # the signed ACDS SDP relay (lib/network/webrtc/ + signaling.c)
        self._p2p_agents: dict[str, object] = {}
        self._p2p_pending: dict[str, asyncio.Future] = {}
        # TURN-role fallback (parallel_connect.c ladder, last rung): when
        # ICE checks fail, the channel rides ACIP_WEBRTC_RELAY through the
        # ACDS — still end-to-end encrypted, the relay is blind
        self._p2p_relay: dict[str, object] = {}
        self._relay_pending: dict[str, asyncio.Future] = {}
        # optional STUN server for server-reflexive candidates ("host:port";
        # lets P2P work behind NATs UPnP can't open)
        self.stun_server: tuple[str, int] | None = None
        # session settings sync (src/common/session/settings.c): the HOST
        # broadcasts versioned display settings; participants apply newer
        # versions and ack
        self.settings: dict = {}
        self.settings_version = 0
        self.settings_acks = 0
        self._settings_acked: set[str] = set()
        self.on_settings = None  # callback(settings dict)
        self._t = None
        self._acds_rtt_ms = 20.0  # measured at connect()
        self._pre_ack: list[tuple[int, bytes]] = []  # broadcasts racing acks
        self._conn_nonce: str | None = None  # ACDS HELLO channel binding
        # measured election inputs (measure_network; None = not yet measured)
        self._upload_kbps: int | None = None
        self._stun_success_pct: int | None = None
        self._nat_tier_measured: int | None = None
        self.upnp_mapped = False  # embedder sets after a UPnP/NAT-PMP map

    def attach_ring(self, interval_s: float = RING_COLLECTION_INTERVAL_S) -> "RingRunner":
        self.ring = RingRunner(self, interval_s)
        return self.ring

    async def connect(self) -> None:
        t0 = time.monotonic()
        raw = await connect_tcp(self.acds_host, self.acds_port)
        # TCP connect time ~= one RTT to the rendezvous: the cheapest real
        # latency measurement available for the election metrics
        self._acds_rtt_ms = (time.monotonic() - t0) * 1000
        self._t = SignedAcdsChannel(raw, self.identity, self.pins)
        # the ACDS greets with a per-connection registration nonce (signed;
        # TOFU-pins the service key as a side effect): echoing it in
        # create/join binds the signed body to THIS connection, closing the
        # captured-envelope replay that could rebind a victim's delivery
        try:
            ptype, payload = await asyncio.wait_for(self._t.recv(), 10)
            if ptype == pkt.PacketType.ACIP_ACDS_HELLO:
                self._conn_nonce = json.loads(payload).get("nonce")
            else:  # pre-nonce server: buffer whatever arrived
                self._pre_ack.append((ptype, payload))
        except (asyncio.TimeoutError, ValueError):
            self._conn_nonce = None

    async def create(self, my_port: int, my_address: str = "127.0.0.1",
                     reserved_string: str | None = None) -> str:
        self.my_address, self.my_port = my_address, my_port
        await self._t.send(pkt.PacketType.ACIP_SESSION_CREATE, json.dumps({
            "participant_id": self.participant_id,
            "address": my_address,
            "port": my_port,
            "reserved_string": reserved_string,
            "nonce": self._conn_nonce,
        }).encode())
        while True:
            ptype, payload = await self._t.recv()
            if ptype == pkt.PacketType.ERROR_MESSAGE:
                raise RuntimeError(json.loads(payload).get("error", "create failed"))
            if ptype not in (pkt.PacketType.ACIP_SESSION_CREATED,):
                # a signed broadcast racing the ack (PARTICIPANT_LIST with
                # peers' pubkeys, HOST_DESIGNATED) used to be silently
                # dropped here — buffer it for event_loop
                self._pre_ack.append((ptype, payload))
                continue
            if ptype == pkt.PacketType.ACIP_SESSION_CREATED:
                resp = json.loads(payload)
                self.session_string = resp["session_string"]
                self.host_id = self.participant_id
                self.host_address, self.host_port = my_address, my_port
                return self.session_string

    async def join(self, session_string: str, my_address: str = "127.0.0.1",
                   my_port: int = 0) -> tuple[str, int]:
        self.my_address, self.my_port = my_address, my_port
        await self._t.send(pkt.PacketType.ACIP_SESSION_JOIN, json.dumps({
            "participant_id": self.participant_id,
            "session_string": session_string,
            "address": my_address,
            "port": my_port,
            "nonce": self._conn_nonce,
        }).encode())
        while True:
            ptype, payload = await self._t.recv()
            if ptype == pkt.PacketType.ERROR_MESSAGE:
                raise RuntimeError(json.loads(payload).get("error"))
            if ptype != pkt.PacketType.ACIP_SESSION_JOINED:
                # see create(): pre-ack broadcasts are buffered, not eaten
                self._pre_ack.append((ptype, payload))
                continue
            if ptype == pkt.PacketType.ACIP_SESSION_JOINED:
                resp = json.loads(payload)
                self.session_string = session_string
                self.host_id = resp["host_id"]
                self.host_address = resp["host_address"]
                self.host_port = resp["host_port"]
                return self.host_address, self.host_port

    async def measure_network(self, probe_bytes: int = 128 * 1024,
                              stun_probes: int = 5,
                              probe_timeout: float = 15.0) -> dict:
        """Measure the election inputs for REAL.

        The reference's metrics collector ships TODO defaults for all of
        these (lib/network/consensus/metrics.c:49-121 — nat_tier=1 and
        50 Mbps hardcoded, measure_stun_probe_success() returns a literal
        90); this measures them:

        - upload_kbps: a timed PING burst over the LIVE ACDS TCP connection
          (the "timed send over the ACDS connection" probe). Each PONG echo
          confirms receipt, so elapsed-to-last-echo minus the measured
          connect RTT bounds the uplink.
        - stun_success_pct + nat_tier: stun_probes real RFC 5389 binding
          requests through net/stun.py when ``stun_server`` is configured;
          the XOR-MAPPED-ADDRESS vs the advertised address classifies the
          NAT tier (1=public, 2=UPnP-mapped, 3=STUN-reachable NAT,
          4=nothing answered — metrics.c:60-85's tier scale).

        Must run while nothing else consumes recv() (between connect() and
        create/join, or before event_loop()); non-PONG packets that race
        the probe are buffered for the event loop like pre-ack broadcasts.
        """
        out: dict = {}
        if self._t is not None:
            chunk = 16 * 1024
            n = max(1, probe_bytes // chunk)
            t0 = time.monotonic()
            try:
                for i in range(n):
                    await self._t.send(pkt.PacketType.PING,
                                       bytes([i & 0xFF]) * chunk)
                got = 0
                while got < n:
                    ptype, payload = await asyncio.wait_for(
                        self._t.recv(), probe_timeout)
                    if ptype == pkt.PacketType.PONG:
                        got += 1
                    else:
                        self._pre_ack.append((ptype, payload))
                elapsed = time.monotonic() - t0
                # uplink time ~= total minus one round trip; a burst that
                # drains entirely inside the RTT (loopback, tiny probe) has
                # no resolvable uplink component — attribute half
                up_s = elapsed - self._acds_rtt_ms / 1000.0
                if up_s <= 0:
                    up_s = elapsed / 2
                self._upload_kbps = max(
                    1, min(int(n * chunk * 8 / up_s / 1000), 10_000_000))
                out["upload_kbps"] = self._upload_kbps
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                log.warning("upload probe failed: %r", e)
        if self.stun_server:
            pct, mapped = await measure_stun_success(
                self.stun_server, n=stun_probes)
            self._stun_success_pct = pct
            out["stun_success_pct"] = pct
            if pct == 0:
                self._nat_tier_measured = 4  # nothing reachable: TURN tier
            elif mapped and mapped[0] == self.my_address:
                self._nat_tier_measured = 1  # un-NATed public address
            elif self.upnp_mapped:
                self._nat_tier_measured = 2
            else:
                self._nat_tier_measured = 3  # NATed, STUN-reachable
            out["nat_tier"] = self._nat_tier_measured
            out["stun_mapped"] = mapped
        return out

    def metrics(self) -> cons.ParticipantMetrics:
        """Election inputs (metrics.c role): measured values from
        measure_network() when it ran; otherwise honest-where-cheap
        defaults — nat_tier from the advertised address's routability
        (a publicly-routable host beats a NATed one as session host) and
        rtt from the measured ACDS connect time (exact ties are resolved
        by the incumbent-sticky election instead of first-wins flapping)."""
        import ipaddress

        tier = self._nat_tier_measured
        if tier is None:
            try:
                ip = ipaddress.ip_address(self.my_address)
                tier = 0 if ip.is_global else 1 if ip.is_private else 2
            except ValueError:
                tier = 1  # hostname: assume NATed-but-reachable
        return cons.ParticipantMetrics(
            participant_id=self.participant_id,
            nat_tier=tier,
            upload_kbps=self._upload_kbps if self._upload_kbps is not None
            else 10_000,
            rtt_ms=max(1, int(self._acds_rtt_ms)),
            stun_success_pct=self._stun_success_pct
            if self._stun_success_pct is not None else 100,
            address=self.my_address,
            port=self.my_port,
        )

    async def event_loop(self) -> None:
        """Track participant lists + host designations; report quality."""
        P = pkt.PacketType

        async def report():
            while True:
                self._t.send_nowait(P.ACIP_NETWORK_QUALITY, self.metrics().pack())
                await asyncio.sleep(QUALITY_REPORT_INTERVAL_S)

        reporter = asyncio.create_task(report())
        try:
            while True:
                if self._pre_ack:
                    # broadcasts that raced the create/join ack: dispatch
                    # them first (they carry peers' pubkeys and host
                    # designations that everything below depends on)
                    ptype, payload = self._pre_ack.pop(0)
                else:
                    ptype, payload = await self._t.recv()
                if ptype == P.ACIP_PARTICIPANT_LIST:
                    try:
                        info = json.loads(payload)
                        participants = list(info["participants"])
                    except (KeyError, ValueError, TypeError) as e:
                        # the only handlers WITHOUT a bad-data guard were
                        # the two whose death silently disabled failover,
                        # pinning and settings sync for the whole session
                        log.warning("bad participant list dropped: %s", e)
                        continue
                    prev = set(self.participants)
                    self.participants = participants
                    # host-authoritative settings reach LATE JOINERS too
                    if (self.settings and self.host_id == self.participant_id):
                        newcomers = [p for p in self.participants
                                     if p not in prev and p != self.participant_id]
                        if newcomers:
                            self._push_settings(newcomers)
                    # pin fellow participants' identity keys (ACDS-signed
                    # list) so relayed ring/SDP messages verify end-to-end
                    for pid, hexkey in (info.get("pubkeys") or {}).items():
                        try:
                            self.pins.check(pid, bytes.fromhex(hexkey))
                        except (ident.SignatureError, ValueError) as e:
                            log.warning("participant %s key conflict: %s", pid, e)
                    if self.ring:
                        self.ring.on_members(self.participants)
                elif ptype == P.ACIP_RING_COLLECT:
                    if self.ring:
                        try:
                            self.ring.on_ring_packet(payload)
                        except (KeyError, ValueError, TypeError) as e:
                            log.warning("bad ring packet dropped: %s", e)
                elif ptype == P.ACIP_WEBRTC_SDP:
                    try:
                        self._on_webrtc_sdp(payload)
                    except (KeyError, ValueError, TypeError) as e:
                        log.warning("bad SDP relay dropped: %s", e)
                elif ptype == P.ACIP_WEBRTC_RELAY:
                    try:
                        self._on_webrtc_relay(payload)
                    except (KeyError, ValueError, TypeError) as e:
                        log.warning("bad data relay dropped: %s", e)
                elif ptype == P.ACIP_SETTINGS_SYNC:
                    try:
                        self._on_settings_sync(payload)
                    except (KeyError, ValueError, TypeError) as e:
                        log.warning("bad settings sync dropped: %s", e)
                elif ptype == P.ACIP_SETTINGS_ACK:
                    try:
                        ack = json.loads(payload)
                        version = int(ack.get("version") or 0)
                    except (ValueError, TypeError, AttributeError) as e:
                        log.warning("bad settings ack dropped: %s", e)
                        continue
                    # count each sender once, current version only (a stale
                    # or duplicate ack must not inflate the counter)
                    if (version == self.settings_version
                            and ack.get("from") in self.participants
                            and ack.get("from") not in self._settings_acked):
                        self._settings_acked.add(ack["from"])
                        self.settings_acks = len(self._settings_acked)
                elif ptype == P.ACIP_HOST_DESIGNATED:
                    try:
                        info = json.loads(payload)
                        _ = info["host_id"], info["host_address"], info["host_port"]
                    except (KeyError, ValueError, TypeError) as e:
                        log.warning("bad host designation dropped: %s", e)
                        continue
                    if info["host_id"] != self.host_id:
                        self.host_id = info["host_id"]
                        self.host_address = info["host_address"]
                        self.host_port = info["host_port"]
                        log.info("host migrated to %s (%s:%d)", self.host_id,
                                 self.host_address, self.host_port)
                        if self.on_host_changed:
                            self.on_host_changed(self.host_address, self.host_port)
        finally:
            reporter.cancel()

    # -- session settings sync (settings.c; versioned, host-authoritative) --
    def broadcast_settings(self, settings: dict) -> int:
        """Host: push display settings to every participant (version =
        wall-clock seconds for ordering, settings.c:175)."""
        import time as _time

        self.settings = dict(settings)
        self.settings_version = max(int(_time.time()), self.settings_version + 1)
        self._settings_acked = set()  # ack bookkeeping restarts per version
        return self._push_settings(
            [p for p in self.participants if p != self.participant_id])

    def _push_settings(self, pids: list[str]) -> int:
        n = 0
        for pid in pids:
            self._t.send_nowait(pkt.PacketType.ACIP_SETTINGS_SYNC, json.dumps({
                "to": pid, "from": self.participant_id,
                "version": self.settings_version, "settings": self.settings,
            }).encode())
            n += 1
        return n

    def _on_settings_sync(self, payload: bytes) -> None:
        data = json.loads(payload)
        frm = data.get("from")
        if frm != self.host_id:
            log.warning("settings sync from non-host %s ignored", frm)
            return
        try:
            version = int(data.get("version") or 0)
        except (TypeError, ValueError):
            return  # malformed version must not kill the event loop
        if version <= self.settings_version:
            return  # stale (settings_needs_update, settings.c:219)
        self.settings = dict(data.get("settings") or {})
        self.settings_version = version
        log.info("session settings v%d applied from host", version)
        if self.on_settings:
            self.on_settings(self.settings)
        self._t.send_nowait(pkt.PacketType.ACIP_SETTINGS_ACK, json.dumps({
            "to": frm, "from": self.participant_id, "version": version,
        }).encode())

    # -- P2P channels over the signed SDP relay ---------------------------
    def _on_webrtc_sdp(self, payload: bytes) -> None:
        data = json.loads(payload)
        frm, kind = data["from"], data.get("kind", "offer")
        if kind == "answer":
            fut = self._p2p_pending.pop(frm, None)
            if fut is not None and not fut.done():
                fut.set_result(data["desc"])
        elif kind == "relay-req":
            # Peer's ICE checks failed; fall back to the blind TURN-role
            # relay. Requires a prior offer/answer (the channel reuses the
            # X25519 keys exchanged in the signaling blobs). The switch is
            # AUTHORITATIVE: even if OUR side nominated a direct pair (one-
            # way-UDP asymmetry can make the responder nominate while the
            # initiator never hears back), the peer has declared the direct
            # path dead — tear it down so both ends agree on the relay and
            # the transports cannot split-brain.
            agent = self._p2p_agents.get(frm)
            if agent is None or agent.remote is None:
                log.warning("relay-req from %s without prior offer; ignored", frm)
                return
            relay = self._p2p_relay.get(frm)
            relay_live = (relay is not None and not relay.closed
                          and not relay.failed)
            if not relay_live:
                # a FAILED prior relay channel must be rebuilt, not kept:
                # answering relay-ok over a dead channel wedged the peer's
                # retry (it waits for a handshake our side will never run)
                if relay is not None:
                    relay.close()
                    del self._p2p_relay[frm]
                agent.stop_ice()
                self._make_relay_channel(frm)
                log.info("P2P with %s falling back to ACDS relay (TURN role)",
                         frm)
            self._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_SDP, json.dumps({
                "to": frm, "from": self.participant_id, "kind": "relay-ok",
            }).encode())
        elif kind == "relay-ok":
            fut = self._relay_pending.pop(frm, None)
            if fut is not None and not fut.done():
                fut.set_result(True)
        else:
            asyncio.get_running_loop().create_task(
                self._p2p_answer(frm, data["desc"]))

    def _on_webrtc_relay(self, payload: bytes) -> None:
        """A relayed channel segment: feed the peer's relay channel. The
        segment is secretbox-encrypted under the ICE session keys, so a
        malicious relay (or a peer spoofing 'from' past the ACDS pin check)
        cannot inject plaintext — decrypt failure drops it silently."""
        import base64

        data = json.loads(payload)
        ch = self._p2p_relay.get(data["from"])
        if ch is not None:
            ch.on_datagram(base64.b64decode(data["data"]))

    def _make_relay_channel(self, peer_id: str):
        agent = self._p2p_agents[peer_id]

        def send_via_relay(enc: bytes) -> None:
            import base64

            self._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_RELAY, json.dumps({
                "to": peer_id, "from": self.participant_id,
                "data": base64.b64encode(enc).decode(),
            }).encode())

        ch = agent.channel
        if ch is not None and not ch.closed:
            # One-way-UDP asymmetry: OUR side nominated a direct pair (the
            # peer's requests reached us) but the peer never heard our
            # answers and fell back. The application may already hold this
            # channel from p2p_accept — REBIND it to the relay carrier
            # instead of replacing it; its unacked segments (secretbox ARQ
            # or SCTP chunks — both carrier-agnostic) retransmit over the
            # relay with their original sequence numbers.
            ch.rebind(send_via_relay, ("acds-relay", peer_id))
        else:
            # the channel type is NEGOTIATED (DTLS-SCTP iff both advertised
            # fingerprints), so both ends build the same protocol over the
            # relay even when only one of them ever nominated a direct pair
            ch = agent.make_channel(send_via_relay,
                                    ("acds-relay", peer_id), via_relay=True)
        self._p2p_relay[peer_id] = ch
        return ch

    async def _p2p_answer(self, frm: str, desc: dict) -> None:
        """Incoming offer: spawn the controlled agent and answer. A fresh
        offer from a peer whose previous negotiation never connected
        replaces the stale agent (retries must be able to succeed)."""
        from asciichat_tpu_torch.net.webrtc import IceLiteAgent

        stale = self._p2p_agents.get(frm)
        if (stale is not None and stale.controlling
                and not stale.connected.is_set()
                and frm not in self._p2p_relay):
            # OFFER GLARE: both sides called p2p_connect simultaneously.
            # Deterministic tie-break — the HIGHER id ignores the incoming
            # offer (its own offer wins on the peer, who yields); the LOWER
            # id yields: closes its outgoing attempt and answers. Without
            # this, each side closed the other's in-flight controlling
            # agent and direct ICE could never succeed.
            if self.participant_id > frm:
                log.info("offer glare with %s: keeping OUR offer", frm)
                return
            log.info("offer glare with %s: yielding to the peer's offer", frm)
            fut = self._p2p_pending.pop(frm, None)
            if fut is not None and not fut.done():
                # a typed exception, not cancel(): p2p_connect catches it
                # and delegates to p2p_accept — its normal cleanup would
                # otherwise close the FRESH controlled agent installed below
                fut.set_exception(_OfferGlare(frm))
        if stale is not None:
            relay = self._p2p_relay.get(frm)
            # "live" for a relay channel means READY and not failed: a DTLS
            # relay whose handshake never completed (initiator gave up and
            # is now re-offering) must count as stale, or this peer would
            # ignore every retry forever
            relay_live = (relay is not None and not relay.closed
                          and relay.ready.is_set() and not relay.failed)
            if stale.connected.is_set() or relay_live:
                return  # live channel exists; ignore duplicate offers
            stale.close()
            del self._p2p_agents[frm]
            if relay is not None:  # dead relay from a failed prior attempt
                relay.close()
                del self._p2p_relay[frm]
        agent = IceLiteAgent(controlling=False)
        await agent.start()
        self._p2p_agents[frm] = agent
        if self.stun_server:
            await agent.gather_srflx(self.stun_server)
        self._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_SDP, json.dumps({
            "to": frm, "from": self.participant_id,
            "kind": "answer", "desc": agent.local_description(),
        }).encode())
        agent.set_remote(desc)

    async def p2p_connect(self, peer_id: str, timeout: float = 10.0,
                          ice_timeout: float | None = None,
                          relay_fallback: bool = True):
        """Negotiate an encrypted P2P channel with another participant,
        walking the reference's connect ladder (parallel_connect.c:1-321):
        offer/answer through the Ed25519-signed ACDS relay, ICE-lite
        connectivity checks for a direct UDP path, and — when both peers sit
        behind NATs that block direct UDP (symmetric NATs) — fall back to
        relaying the still-end-to-end-encrypted channel through the ACDS
        (the TURN role; the relay host cannot read or forge segments)."""
        from asciichat_tpu_torch.net.webrtc import IceLiteAgent

        if ice_timeout is None:
            ice_timeout = min(4.0, timeout / 2)
        agent = IceLiteAgent(controlling=True)
        await agent.start()
        if self.stun_server:
            await agent.gather_srflx(self.stun_server)
        self._p2p_agents[peer_id] = agent
        fut = asyncio.get_running_loop().create_future()
        self._p2p_pending[peer_id] = fut
        self._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_SDP, json.dumps({
            "to": peer_id, "from": self.participant_id,
            "kind": "offer", "desc": agent.local_description(),
        }).encode())
        try:
            try:
                desc = await asyncio.wait_for(fut, timeout)
            except _OfferGlare:
                # both sides offered at once and we are the yielding (lower)
                # id: our agent was replaced by the peer's-offer controlled
                # agent — wait for THAT negotiation instead
                return await self.p2p_accept(peer_id, timeout)
            agent.set_remote(desc)
            try:
                ch = await agent.wait_connected(ice_timeout)
                # DTLS-SCTP channels handshake after nomination; a nominated
                # pair whose DTLS can't complete (one-way UDP) falls through
                # to the relay rung like a failed ICE check would
                ch = await ch.wait_ready(ice_timeout)
                self._attach_consent_failover(peer_id, agent)
                return ch
            except (asyncio.TimeoutError, TimeoutError, ConnectionError):
                if not relay_fallback:
                    raise
                log.info("ICE checks to %s failed after %.1fs; trying ACDS "
                         "relay (TURN role)", peer_id, ice_timeout)
                ch = await self._relay_connect(peer_id, timeout)
                return await ch.wait_ready(timeout)
        except (asyncio.TimeoutError, TimeoutError, ConnectionError):
            # clean up so a retry starts fresh (stale agents also hold the
            # UDP socket open). ConnectionError: a DTLS relay channel can
            # fail-closed (fingerprint/SCTP abort) after _make_relay_channel
            # populated the maps. The relay entry MUST go too — a zombie
            # not-closed never-ready channel there makes _p2p_answer ignore
            # every fresh offer and the relay-req handler skip rebuilding,
            # permanently wedging P2P with that peer.
            self._p2p_pending.pop(peer_id, None)
            self._p2p_agents.pop(peer_id, None)
            self._relay_pending.pop(peer_id, None)
            relay = self._p2p_relay.pop(peer_id, None)
            if relay is not None:
                relay.close()
            agent.close()
            raise

    def _attach_consent_failover(self, peer_id: str, agent) -> None:
        """Mid-session path-death recovery (RFC 7675 consent + the ladder's
        relay rung): when the agent's nominated pair loses consent AND
        re-nomination over every known candidate (incl. promoted prflx)
        fails, fall back to the ACDS relay — the channel object the
        application holds is rebound, so frames keep flowing."""

        def on_fail():
            if peer_id in self._p2p_relay or self._t is None:
                return
            log.warning("P2P direct path to %s died mid-session; "
                        "switching to ACDS relay", peer_id)
            asyncio.get_running_loop().create_task(_switch())

        async def _switch():
            try:
                await self._relay_connect(peer_id, timeout=15.0)
            except Exception:
                log.exception("mid-session relay fallback to %s failed",
                              peer_id)

        agent.on_pair_failed = on_fail

    async def _relay_connect(self, peer_id: str, timeout: float):
        """Last ladder rung: ask the peer to switch to the ACDS data relay,
        then bring up the channel over ACIP_WEBRTC_RELAY segments. The ICE
        agent's probing stops NOW (socket + retx task released; a late STUN
        answer must not nominate a second, unread channel) — only its
        session crypto stays alive for the relay channel."""
        agent = self._p2p_agents[peer_id]
        agent.stop_ice()
        fut = asyncio.get_running_loop().create_future()
        self._relay_pending[peer_id] = fut
        self._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_SDP, json.dumps({
            "to": peer_id, "from": self.participant_id, "kind": "relay-req",
        }).encode())
        await asyncio.wait_for(fut, timeout)
        return self._make_relay_channel(peer_id)

    async def p2p_accept(self, peer_id: str, timeout: float = 10.0):
        """Wait for the channel negotiated from an incoming offer — direct
        (ICE) or relayed (TURN-role fallback), whichever establishes."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while peer_id not in self._p2p_agents:
            if loop.time() > deadline:
                raise TimeoutError(f"no P2P offer from {peer_id}")
            await asyncio.sleep(0.05)
        while True:
            # re-fetch EVERY pass: a retried offer replaces the agent in
            # _p2p_answer, and polling a captured (closed) first agent made
            # the accept time out while a live channel sat in the map
            agent = self._p2p_agents.get(peer_id)
            if agent is None:
                if loop.time() > deadline:
                    raise TimeoutError(f"no P2P channel with {peer_id}")
                await asyncio.sleep(0.05)
                continue
            # relay wins ties: a relay-req means the peer's direct path is
            # dead even if OUR side nominated one (one-way-UDP asymmetry)
            ch = self._p2p_relay.get(peer_id)
            if ch is None and agent.connected.is_set():
                ch = agent.channel
            # a DTLS-SCTP channel is handed out only once its handshakes
            # finish (secretbox channels are born ready); a FAILED direct
            # channel keeps us waiting — the peer will fall back to relay
            if ch is not None and ch.ready.is_set() and not ch.failed:
                if not ch.via_relay:
                    self._attach_consent_failover(peer_id, agent)
                return ch
            if loop.time() > deadline:
                raise TimeoutError(f"no P2P channel with {peer_id}")
            await asyncio.sleep(0.05)

    async def leave(self) -> None:
        for ch in self._p2p_relay.values():
            ch.close()
        for agent in self._p2p_agents.values():
            agent.close()
        if self._t:
            if self.session_string:
                with contextlib.suppress(ConnectionError):
                    await self._t.send(pkt.PacketType.ACIP_SESSION_LEAVE, b"{}")
            # close unconditionally: a connect()-then-failed-create session
            # used to leak the ACDS connection for the process lifetime
            await self._t.close()


async def _viewer_loop(sess: DiscoverySession, args, writer_factory) -> int:
    """Follow the designated host: (re)connect the viewer client whenever the
    ACDS announces a migration (host failover, participant.c role)."""
    from asciichat_tpu_torch.apps.client import AsciiChatClient
    from asciichat_tpu_torch.net import protocol as proto
    from asciichat_tpu_torch.utils import term

    caps = term.detect_capabilities()
    w, h = term.terminal_size(args.width, args.height)
    received_total = 0
    while True:
        host, port = sess.host_address, sess.host_port
        if sess.host_id == sess.participant_id:
            host, port = "127.0.0.1", sess.my_port  # we ARE the host
        remaining = None if args.max_frames is None else args.max_frames - received_total
        if remaining is not None and remaining <= 0:
            return received_total
        changed = asyncio.Event()
        sess.on_host_changed = lambda a, p: changed.set()
        client = AsciiChatClient(
            host, port, writer_factory(),
            proto.WireCapabilities(caps=caps, width=w, height=h),
            reconnect=False,
        )
        run_task = asyncio.create_task(client.run(max_frames=remaining))
        changed_task = asyncio.create_task(changed.wait())
        done, _ = await asyncio.wait({run_task, changed_task},
                                     return_when=asyncio.FIRST_COMPLETED)
        received_total += client.frames_received
        if run_task in done:
            changed_task.cancel()
            exc = run_task.exception()
            if exc is None and (args.max_frames is None or received_total >= args.max_frames):
                return received_total
            # connection to the host died: wait for a HOST_DESIGNATED
            log.warning("viewer lost the host (%s); awaiting re-election",
                        exc or "stream ended")
            try:
                await asyncio.wait_for(changed.wait(), timeout=30)
            except asyncio.TimeoutError:
                return received_total
        else:
            # migration announced mid-stream: reconnect to the new host
            run_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await run_task


async def run_discovery(args) -> int:
    from asciichat_tpu_torch.apps.server import AsciiChatServer
    from asciichat_tpu_torch.runtime.framesource import open_source

    sess = DiscoverySession(args.acds, args.acds_port)
    if getattr(args, "stun", None):
        host_part, _, port_part = args.stun.rpartition(":")
        sess.stun_server = (host_part or args.stun, int(port_part or 3478))
    p2p_dtls = (getattr(args, "p2p_dtls", "auto") or "auto").lower()
    if p2p_dtls != "auto":
        from asciichat_tpu_torch.net import webrtc as webrtc_mod

        webrtc_mod.DTLS_DEFAULT = p2p_dtls not in ("off", "0", "false", "no")
    ring = sess.attach_ring(getattr(args, "ring_interval", None)
                            or RING_COLLECTION_INTERVAL_S)
    await sess.connect()
    # measure the election inputs over the live connection BEFORE create/
    # join (nothing else consumes recv() yet): upload probe + STUN probes
    # feed metrics() so elections can actually distinguish a DSL host from
    # a datacenter one
    try:
        measured = await asyncio.wait_for(sess.measure_network(), 25)
        if measured:
            log.info("measured election metrics: %s", measured)
    except Exception as e:  # measurement is best-effort, never fatal
        log.warning("network measurement failed (%r); nominal metrics", e)

    # every participant runs a standby server so it can be elected host
    standby = AsciiChatServer("0.0.0.0", args.port)
    from asciichat_tpu_torch.net.transport import serve_tcp

    standby_srv = await serve_tcp(standby._handle_conn, "0.0.0.0", args.port)
    standby_tick = asyncio.get_running_loop().create_task(standby._tick_loop())

    if args.join:
        host, port = await sess.join(args.join, my_address=args.advertise,
                                     my_port=args.port)
        log.info("joined %s -> host at %s:%d (standby server on :%d)",
                 args.join, host, port, args.port)
        print(f"session: {args.join}\nhost: {host}:{port}", flush=True)
    else:
        session_string = await sess.create(args.port, my_address=args.advertise)
        print(f"session: {session_string}", flush=True)
        log.info("hosting session %s on port %d", session_string, args.port)

    events = asyncio.create_task(sess.event_loop())

    def _events_died(t):
        # the event loop carries failover/pinning/settings for the WHOLE
        # session — its death must be loud, not an unobserved exception
        # discovered at exit
        if not t.cancelled() and t.exception() is not None:
            log.error("ACDS event loop died: %r — host failover, key "
                      "pinning and settings sync are DISABLED", t.exception())

    events.add_done_callback(_events_died)
    ring_task = asyncio.create_task(ring.leader_loop())
    try:
        if args.join or args.view:
            # joiners view the designated host; creators only with --view
            # (a self-viewing host triples the per-participant load)
            n = await _viewer_loop(sess, args,
                                   lambda: open_source(test_pattern=True))
            log.info("viewer received %d frames", n)
        else:
            await asyncio.Event().wait()  # host: serve until interrupted
        return 0
    finally:
        events.cancel()
        ring_task.cancel()
        standby_tick.cancel()
        standby_srv.close()
        await sess.leave()


def main(args) -> int:
    try:
        return asyncio.run(run_discovery(args))
    except KeyboardInterrupt:
        return 0
