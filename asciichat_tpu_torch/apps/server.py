"""ascii-chat server on the PyTorch port: N clients in, personalized ASCII
frames + mixed audio out.

    python -m asciichat_tpu_torch.apps.main server --port 27224

The JAX-free counterpart of ``asciichat_tpu/apps/server.py``. The host logic
(connections, receive loop, broadcast and pacing, the render and audio
ticks, the loops, sweep and inspector) is copied as it stands, in the same
order and under the same names; only the device seam differs:
- the source stack is a pinned ``torch.uint8`` pool; a fresh layout uploads
  all of it, after that only the rows whose frame advanced are copied
  (``_upload_stack``);
- the video tick renders every geometry group with one
  ``models/server.render_groups`` call (one K3 launch on a CUDA device) into
  the server's ``RecordArena`` and fetches them all with one copy;
- multi-device serving (``parallel/mesh.serving_mesh``): with
  ``ASCIICHAT_FORCE_MESH=N`` the render is sharded N ways on the server's
  own device, and with more than one visible card over all of them
  (``ASCIICHAT_MESH_SPACE=K`` shards cell rows too). The stack is copied
  from the server's device to each other device of the mesh once per tick
  (where the JAX package all-gathers it), each shard is one K3 launch, and
  the records come back on the host in the unsharded layout
  (``models/server.MeshArena``). The inspector's ``mesh`` is the grid's
  shape and ``mesh_collectives`` the last tick's device-to-device stack
  copies (0 when every shard shares one card). A mesh that was asked for
  and cannot be built stops the server's start;
- the audio tick mixes with the port's ``mixer_process`` (K4 on a CUDA
  device) on a CUDA stream of its own;
- a video tick whose device work fails is logged at ERROR, counted
  (``device_failures`` on the inspector) and skipped: nothing is rendered on
  the host while the server's device is the card;
- ``net.crypto`` and the other ``cryptography`` users are imported only when
  a client opens with a crypto handshake packet (types 1000-1199) or an auth
  option is given, so a plaintext server runs where ``cryptography`` is not
  installed; an auth option without it refuses to start;
- it serves TCP, WebSocket with the browser client's page (``ws_port``,
  ``net/websocket.py``, ``apps/webclient.py``) and announces itself over mDNS
  (``mdns``, ``net/mdns.py``); the WebSocket listener answers WebRTC
  signaling (``POST /webrtc/offer`` and ``/webrtc/candidate``,
  ``apps/webclient.WebRtcGateway``) where the system libssl loads and
  ``cryptography`` imports, and answers no POST elsewhere (as the JAX server
  does wherever ``net/dtls`` is unavailable). A WebRTC DataChannel joins
  through the same handler (``_handle_conn``) as TCP and WebSocket.
The host modules it uses (``net/``, ``runtime/``, ``utils/``, ``render/``)
are the port's own copies of the JAX package's.
The device is ``ASCIICHAT_TORCH_DEVICE`` (``cuda`` by default, ``cpu`` for
the plain versions); a forced mesh never changes it.

Asyncio re-expression of src/server/: where the reference runs 5 thread
types (per-client receive/send/dispatch + 60 fps video render + 100 fps audio
render threads, src/server/{client.c,render.c}), this server runs per-client
asyncio tasks and ONE render tick that converts the shared composite once per
distinct (caps, size, palette, filter) group on the device — the per-client
fan-out is a batch/group dimension, not a thread count (SURVEY §2e.3).

Protocol parity: ACIP framing + CRC32-C (net/packet.py), IMAGE_FRAME uploads
-> latest-frame double buffer (video_frame.c semantics), ASCII_FRAME
downloads with zstd (server stream path, stream.c:958), AUDIO_BATCH duplex
with exclude-self mixes (mixer.c:636), PING/PONG keepalive
(protocol.c:647), protocol violations disconnect (protocol.c:755).
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import time

import numpy as np
import torch

from asciichat_tpu_torch.models.server import (RENDER_GROUP_KERNEL, MeshArena, RecordArena,
                                               RenderGroup, render_groups)
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import protocol as proto
from asciichat_tpu_torch.net.transport import Transport, serve_tcp
from asciichat_tpu_torch.ops import audio as audio_ops
from asciichat_tpu_torch.ops import filters
from asciichat_tpu_torch.parallel import mesh as meshlib
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.runtime.device import default_device
from asciichat_tpu_torch.runtime.double_buffer import LatestFrame
from asciichat_tpu_torch.runtime.ringbuffer import AudioRing
from asciichat_tpu_torch.utils.logsys import get_logger, ring_log
from asciichat_tpu_torch.utils.ui import Stats

log = get_logger("server")

MAX_CLIENTS = 32  # include/ascii-chat/common/limits.h:26
HANDSHAKE_TIMEOUT_S = 15.0  # pre-registration deadline (unsweepable phase)
MAX_UPLOAD_W, MAX_UPLOAD_H = 800, 600  # client capture cap (capture.c:41-44)
# Clamp client-declared terminal dims (u16 on the wire) so a hostile client
# can't force giant composites / per-shape group rebuilds (reference clamps
# dims server-side, e.g. handlers.c:254).
MAX_TERM_W, MAX_TERM_H = 1024, 512
MIN_TERM_W, MIN_TERM_H = 4, 2  # degenerate dims break render planning
VIDEO_TICK = 1 / 60  # server render cadence (render.c:41)
AUDIO_TICK = 480 / 48000  # 10 ms audio tick (render.c:42)
# Keepalive sweep (src/client/keepalive.c counterpart, server side): clients
# ping every 5 s; a peer silent past PING_PROBE_S gets a server PING, and one
# silent past CLIENT_TIMEOUT_S is disconnected — without this, half-open
# connections (partition without RST, frozen tabs) hold slots until
# MAX_CLIENTS fills: an unauthenticated slot-exhaustion DoS.
PING_PROBE_S = 20.0
CLIENT_TIMEOUT_S = 60.0
# RenderGroup LRU bound: groups hold device buffers (comp maps and K3's
# word maps); geometry churn past this evicts the least-recently-served
# groups.
GROUP_CACHE_MAX = 16
# Periodic gc+malloc_trim cadence in the video loop (see the maintenance
# block there).
MAINT_INTERVAL_S = 20.0


def _malloc_trim() -> None:
    """Return freed glibc arenas to the OS after a burst of allocations.

    glibc keeps freed arenas mapped, so a churny session's RSS ratchets to
    its worst moment. Best-effort and Linux-only; a missing symbol is
    silently fine."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).malloc_trim(0)
    except Exception:
        pass


class ClientState:
    def __init__(self, cid: int, transport):
        self.id = cid
        self.transport = transport
        self.wire_caps = proto.WireCapabilities()
        self.has_caps = False
        self.streaming = False
        self.video = LatestFrame()
        # 1s of headroom; overflow truncates the WRITE (newest dropped) —
        # oldest-dropping latency bounding is the CONSUMER's job, done by
        # _audio_tick's backlog shed (do not remove that believing the ring
        # handles it)
        self.audio = AudioRing(48000)
        self.last_seen = time.monotonic()
        self.filter_name = "none"
        self.pending_first: tuple[int, bytes] | None = None
        self.h265 = None  # per-client decoder ctx (session/h265/server.c:14-25)
        self.h265_unavailable = False  # codec refused once: stop retrying
        self.opus = None  # per-client Opus ctx (render.c:57 per-client codec)
        self.next_frame_due = 0.0  # desired_fps pacing (sub-tick-rate only)

    @property
    def size_key(self):
        wc = self.wire_caps
        return (wc.caps, wc.width, wc.height, wc.palette_type, wc.palette_custom,
                self.filter_name)


# palette_type wire values (palette.h:88-98): 0 standard .. 4 cool, 5 custom
_PALETTE_TYPE_NAMES = ("standard", "blocks", "digital", "minimal", "cool")


def _client_palette(wc, server_palette: str) -> str:
    """Per-client palette (initialize_client_palette, protocol.c:1670-1719):
    non-empty palette_custom wins (our JS client sends custom chars with
    type 0 — lenient where the reference requires type 5), builtin types
    1-4 select their ramps, anything else inherits the server palette."""
    if wc.palette_custom:
        return wc.palette_custom
    if 1 <= wc.palette_type <= 4:
        return pal.BUILTIN_PALETTES[_PALETTE_TYPE_NAMES[wc.palette_type]]
    return server_palette


class AsciiChatServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 27224,
                 palette: str = pal.DEFAULT_PALETTE, compression_level: int = 1,
                 password: str | None = None, ws_port: int | None = None,
                 mdns: bool = False, inspect_port: int | None = None,
                 status_screen: bool = False, allowed_keys=None,
                 gpg_keyring=None, host_identity=None):
        self.status_screen = status_screen
        self.allowed_keys = allowed_keys  # sshauth.AuthorizedKeys | None
        self.gpg_keyring = gpg_keyring  # gpgauth.GpgKeyring | None
        # persistent Ed25519 HOST identity: proves the server to key-auth
        # clients (net/knownhosts.py; lib/crypto/known_hosts.c role)
        self.host_identity = host_identity
        self.host = host
        self.port = port
        self.ws_port = ws_port
        self.mdns = mdns
        self.inspect_port = inspect_port
        self.password = password
        self.palette = palette
        self.compression_level = compression_level
        self.clients: dict[int, ClientState] = {}
        self._ids = itertools.count(1)
        self._pending_conns = 0  # handshaking, not yet in self.clients
        self._age_seqs: dict[int, int] = {}  # frame_age: last counted seq
        self.device = default_device()
        self.mixer_state: tuple | None = None
        self.mixer_slots: list[int] = []
        self._server: asyncio.AbstractServer | None = None
        self.ticks = 0
        self.stats = Stats()
        import os as _os

        self.client_timeout = float(
            _os.environ.get("ASCIICHAT_CLIENT_TIMEOUT", CLIENT_TIMEOUT_S))
        self._group_cache: dict[tuple, object] = {}
        self._group_last_used: dict[tuple, int] = {}  # LRU stamps (tick seq)
        self._tick_seq = 0
        self._trimmed_at_creates = 0  # malloc_trim watermark (group rebuilds)
        self._last_gc_trim = 0.0  # gc/trim throttle (<=1 pass per 5 s)
        self._stack_pool: torch.Tensor | None = None  # per-tick source stack (pinned)
        self._stack_layout = None  # (shape, client ids, sizes) of the pool
        self._stack_seqs: dict[int, int] = {}  # client id -> copied frame seq
        self._stack_hwm = (0, 0, 0)  # (n_src, hmax, wmax) shape watermark
        self._dev_stack = None  # device-resident stack
        # Multi-device serving (parallel/mesh.serving_mesh): a forced or
        # multi-card mesh shards every group's render over its grid, the
        # reference's 2-threads-per-client fan-out (src/server/render.c:16-38)
        # as shards. No `except`: a mesh that was asked for and cannot be
        # built stops the start rather than serving on one device.
        self.mesh = meshlib.serving_mesh(self.device)
        if self.mesh is not None:
            log.info("multi-device serving mesh: %s", self.mesh.shape)
        self.mesh_collectives = 0  # device-to-device stack copies in the last tick
        # every group's records, each tick
        self._arena = (MeshArena(self.mesh) if self.mesh is not None
                       else RecordArena(self.device))
        self._stack_event = None  # CUDA event: the last upload's reads of the pool
        # the audio tick's own CUDA stream: a blocking video fetch on the
        # render thread's stream never delays a mix
        self._audio_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._audio_host = None  # (samples, active, mixes) host buffers
        self.device_failures = 0  # failed (skipped) video ticks, for the inspector
        self.audio_failures = 0  # failed (skipped) audio ticks, for the inspector
        self.tick_compute_count = 0
        self.group_creates = 0  # RenderGroup (re)builds: layout/geometry churn signal
        # source-stack layout changes (join/leave/resize); distinct from
        # group_creates, which only counts group-cache MISSES — with the
        # LRU a churn client's return legitimately reuses its group, so
        # replans are the honest churn-coverage signal
        self.layout_replans = 0
        # Latency/deadline observability: per-stage tick
        # timers (ASCII_BREAKDOWN analog, ascii.c:268-382), p50/p99 tick
        # latency, frame age (capture->pickup wait), SLOW-tick warnings
        # against the 16.67 ms deadline (render.c:4-7).
        from asciichat_tpu_torch.utils.logsys import RateLimited
        from asciichat_tpu_torch.utils.trace import LatencyTracker, Tracer

        self.tick_tracer = Tracer("tick")
        self.tick_latency = LatencyTracker()  # tick start -> frames queued
        self.audio_latency = LatencyTracker()  # audio tick start -> mixes queued
        self.frame_age = LatencyTracker()  # upload commit -> tick pickup
        self._slow_rate = RateLimited(5.0)
        self._fail_rate = RateLimited(5.0)  # device-failure tracebacks
        self._tick_deadline = VIDEO_TICK

    # ------------------------------------------------------------------
    # Connection handling

    async def _handle_conn(self, t: Transport) -> None:
        # slot reservation is check-then-INCREMENT with no await between:
        # counting only self.clients let a burst of concurrent connections
        # all pass the check mid-handshake and blow straight past the cap
        if len(self.clients) + self._pending_conns >= MAX_CLIENTS:
            await t.send(pkt.PacketType.ERROR_MESSAGE,
                         proto.pack_error(proto.WireError.SERVER_FULL, "server full"))
            return
        self._pending_conns += 1
        try:
            state = await self._negotiate_conn(t)
        finally:
            self._pending_conns -= 1
        if state is None:
            return
        cid = state.id
        self.clients[cid] = state
        log.info("client %d connected from %s%s", cid, t.peername,
                 " (encrypted)" if state.transport is not t else "")
        await self._broadcast_state()
        try:
            await self._recv_loop(state)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except ValueError as e:
            # protocol violation -> disconnect (disconnect_client_for_bad_data)
            log.warning("client %d bad data: %s", cid, e)
        finally:
            self.clients.pop(cid, None)
            if state.h265 is not None:
                state.h265.close()
            if state.opus:
                state.opus.close()
            log.info("client %d disconnected", cid)
            await self._broadcast_state()

    async def _negotiate_conn(self, t: Transport) -> "ClientState | None":
        """First-packet crypto negotiation + handshake, under a deadline.

        The whole pre-registration phase is bounded by HANDSHAKE_TIMEOUT_S:
        connections parked here are NOT in self.clients, so the keepalive
        sweep cannot reclaim them — without the deadline, an attacker who
        connects and sends nothing (or half a handshake) holds an fd and a
        task forever (half-open slot/fd exhaustion)."""
        cid = next(self._ids)
        # Crypto negotiation: the first packet decides (handshake packets are
        # plaintext, packet.h:304); anything else proceeds unencrypted.
        chan = t
        try:
            async with asyncio.timeout(HANDSHAKE_TIMEOUT_S):
                first = await t.recv()
                # A server requiring auth (password or SSH keys) requires the
                # FULL handshake: both non-crypto first packets AND an
                # explicit CRYPTO_NO_ENCRYPTION opt-out are rejected
                # (lib/crypto/handshake/server.c:177-189 — no plaintext
                # downgrade when auth is required).
                auth_required = (bool(self.password)
                                 or self.allowed_keys is not None
                                 or self.gpg_keyring is not None)
                if auth_required and (
                    not (1000 <= first[0] <= 1199)
                    or first[0] == pkt.PacketType.CRYPTO_NO_ENCRYPTION
                ):
                    await t.send(pkt.PacketType.ERROR_MESSAGE,
                                 proto.pack_error(proto.WireError.ENCRYPTION_REQUIRED, "encryption required"))
                    return None
                if 1000 <= first[0] <= 1199:
                    try:
                        from asciichat_tpu_torch.net.crypto import CryptoContext
                        from asciichat_tpu_torch.net.handshake import (
                            SecureChannel, server_handshake)
                    except ImportError as e:
                        # a plaintext server runs without `cryptography`;
                        # an encrypted session cannot be served then
                        log.error("encrypted session from %s refused: %s",
                                  t.peername, e)
                        return None
                    ctx = CryptoContext()
                    if self.password:
                        ctx.set_password(self.password)
                    if await server_handshake(t, ctx, first,
                                              require_auth=auth_required,
                                              allowed_keys=self.allowed_keys,
                                              gpg_keyring=self.gpg_keyring,
                                              host_identity=self.host_identity):
                        chan = SecureChannel(t, ctx, initiator=False)
                    first = None
        except TimeoutError:
            log.warning("handshake with %s timed out after %.0fs",
                        t.peername, HANDSHAKE_TIMEOUT_S)
            return None
        except (asyncio.IncompleteReadError, ValueError) as e:  # HandshakeError is a ValueError
            log.warning("handshake with %s failed: %s", t.peername, e)
            return None
        state = ClientState(cid, chan)
        state.pending_first = first
        return state

    async def _recv_loop(self, c: ClientState) -> None:
        P = pkt.PacketType
        while True:
            if c.pending_first is not None:
                ptype, payload = c.pending_first
                c.pending_first = None
            else:
                ptype, payload = await c.transport.recv()
            c.last_seen = time.monotonic()
            if ptype == P.PROTOCOL_VERSION:
                await c.transport.send(P.PROTOCOL_VERSION, payload)
            elif ptype == P.CLIENT_CAPABILITIES:
                c.wire_caps = proto.WireCapabilities.unpack(payload)
                c.wire_caps.width = min(max(c.wire_caps.width, MIN_TERM_W), MAX_TERM_W)
                c.wire_caps.height = min(max(c.wire_caps.height, MIN_TERM_H), MAX_TERM_H)
                c.filter_name = (
                    filters.FILTER_NAMES[c.wire_caps.color_filter]
                    if c.wire_caps.color_filter < len(filters.FILTER_NAMES)
                    else "none"
                )
                c.has_caps = True
                await c.transport.send(P.CLEAR_CONSOLE)
                await self._broadcast_state()
            elif ptype == P.SIZE_MESSAGE:
                w, h = proto.unpack_size(payload)
                c.wire_caps.width = min(max(w, MIN_TERM_W), MAX_TERM_W)
                c.wire_caps.height = min(max(h, MIN_TERM_H), MAX_TERM_H)
            elif ptype == P.STREAM_START:
                await self._set_streaming(c, True)
            elif ptype == P.STREAM_STOP:
                await self._set_streaming(c, False)
            elif ptype == P.IMAGE_FRAME:
                pixels, w, h, fmt = pkt.unpack_image_frame(payload)
                # a 0-dim frame would poison the compositor plan with NaN
                # aspect math every tick (remote DoS) — reject a minimum too
                if (fmt != pkt.PIXEL_FORMAT_RGB24 or not 1 <= w <= MAX_UPLOAD_W
                        or not 1 <= h <= MAX_UPLOAD_H):
                    raise ValueError(f"bad image frame {w}x{h} fmt={fmt}")
                frame = np.frombuffer(pixels, np.uint8).reshape(h, w, 3)
                c.video.commit(frame)
                await self._set_streaming(c, True)
            elif ptype == P.IMAGE_FRAME_H265:
                # per-client decode context, lazily opened on the first AU
                # (src/session/h265/server.c:14-25); dims ride the header
                au, w, h, fmt = pkt.unpack_image_frame(payload)
                if not 1 <= w <= MAX_UPLOAD_W or not 1 <= h <= MAX_UPLOAD_H:
                    raise ValueError(f"bad h265 frame dims {w}x{h}")
                from asciichat_tpu_torch.runtime import codecs

                if c.h265_unavailable:
                    continue  # already told this client to fall back once
                if c.h265 is None or (c.h265.width, c.h265.height) != (w, h):
                    # create/close are BLOCKING native/subprocess work (the
                    # ffmpeg-fallback close waits up to ~15 s): on the loop
                    # thread they stalled every client's recv — and a client
                    # alternating dims forced it per frame. Same executor
                    # discipline as decode(); only this task touches c.h265.
                    old, c.h265 = c.h265, None

                    def _reopen(_old=old, _w=w, _h=h):
                        if _old is not None:
                            _old.close()
                        return codecs.H265Decoder(_w, _h)

                    try:
                        c.h265 = await asyncio.get_running_loop(
                        ).run_in_executor(None, _reopen)
                    except codecs.CodecUnavailable as e:
                        # we never advertised h265; tell the client to fall
                        # back ONCE — retrying the probe per frame re-sent
                        # the error for every in-flight frame
                        c.h265_unavailable = True
                        await c.transport.send(P.ERROR_MESSAGE,
                                               proto.pack_error(proto.WireError.CODEC_UNAVAILABLE, str(e)))
                        continue
                # native decode (avcodec + swscale, several ms at 800x600)
                # must not serialize ahead of every other client's recv on
                # the loop thread — the same reason the render/audio ticks
                # run in executors; only this task touches c.h265
                frames = await asyncio.get_running_loop().run_in_executor(
                    None, c.h265.decode, au)
                for frame in frames:
                    c.video.commit(frame)
                await self._set_streaming(c, True)
            elif ptype == P.AUDIO_BATCH:
                body, _bc, total, rate, ch = pkt.unpack_audio_batch(payload)
                # the mixer is fixed 48 kHz mono (audio.h:85-91); feeding it
                # 44.1 kHz or interleaved stereo as-is would mix pitch-
                # shifted/interleaved garbage into every listener — reject
                # as a protocol violation (bad-data disconnect)
                if rate != audio_ops.SAMPLE_RATE or ch != 1:
                    raise ValueError(
                        f"unsupported audio format {rate}Hz/{ch}ch "
                        f"(need {audio_ops.SAMPLE_RATE}/mono)")
                c.audio.write(np.frombuffer(body, "<f4")[:total])
            elif ptype == P.PING:
                await c.transport.send(P.PONG, payload)
            elif ptype == P.CLIENT_JOIN:
                # announces media capability (packet.h:5003)
                await self._set_streaming(c, True)
            elif ptype == P.REMOTE_LOG:
                # bidirectional remote logging (packet.h:2004)
                log.info("remote[%d]: %s", c.id,
                         payload[:500].decode(errors="replace"))
            elif ptype == P.AUDIO_OPUS_BATCH:
                # per-client Opus decode into the same mixer ring
                # (render.c:57 per-client codec contexts)
                from asciichat_tpu_torch.runtime import codecs

                body, _bc, total, _rate, _ch = pkt.unpack_audio_batch(payload)
                if c.opus is None:
                    try:
                        c.opus = codecs.OpusCodec()
                    except codecs.CodecUnavailable:
                        c.opus = False  # no libopus: acknowledged, not mixed
                if c.opus:
                    try:
                        c.audio.write(c.opus.decode(body)[:total])
                    except ValueError as e:
                        log.warning("client %d bad opus packet: %s", c.id, e)
            elif ptype == P.CLIENT_LEAVE:
                return
            elif ptype == P.TEXT_MESSAGE:
                await self._broadcast(P.TEXT_MESSAGE, payload, exclude=c.id)
            # unknown types are tolerated (forward compat)

    async def _set_streaming(self, c: "ClientState", on: bool) -> None:
        """Track stream start/stop and rebroadcast the roster on the
        transition (the reference rebroadcasts server state when a client's
        media starts, STREAM_START handling in src/server/protocol.c) —
        without this, viewers' rosters go stale at the pre-stream count."""
        if c.streaming != on:
            c.streaming = on
            await self._broadcast_state()

    async def _broadcast_state(self) -> None:
        """PACKET_TYPE_SERVER_STATE: current roster to all clients
        (src/server state broadcast, packet.h:5008)."""
        import json

        from asciichat_tpu_torch.runtime.codecs import probe_h265_encoder, probe_video_codecs

        codecs = probe_video_codecs()
        payload = json.dumps({
            "clients": len(self.clients),
            "streaming": sum(1 for c in self.clients.values() if c.streaming),
            "max_clients": MAX_CLIENTS,
            # codec negotiation: clients only send IMAGE_FRAME_H265 after the
            # server advertises a decoder (capability-gated fallback to raw)
            "codecs": codecs,
            # negotiated encoder implementation (probe order encoder.c:67-84);
            # cached probe — the startup codec warm already paid the open
            "h265_encoder": probe_h265_encoder() if "h265" in codecs else None,
        }).encode()
        await self._broadcast(pkt.PacketType.SERVER_STATE, payload)

    async def _broadcast(self, ptype, payload: bytes, exclude: int = -1) -> None:
        for cid, c in list(self.clients.items()):
            if cid != exclude and c.has_caps:
                c.transport.send_nowait(ptype, payload)

    # ------------------------------------------------------------------
    # Render tick: composite once, convert once per caps-group

    def _frame_paced_out(self, c: ClientState, now: float) -> bool:
        """Per-client desired_fps pacing (sub-tick-rate only).

        The reference paces per-client sends (protocol.py:37 carries the
        client's desired_fps); dumping 60 fps on a 10 fps receiver wastes
        ~6x bandwidth AND fills its bounded send queue so drops land on the
        NEWEST frames — the client sees maximally stale output. Clients at
        or above the 60 Hz tick rate are untouched (pacing jitter must not
        skip ticks for default desired_fps=60 clients)."""
        fps = c.wire_caps.desired_fps
        if not 0 < fps < round(1 / VIDEO_TICK):
            return False
        if now < c.next_frame_due:
            return True
        # token-bucket: at most one frame per 1/fps, no burst after a gap
        c.next_frame_due = max(c.next_frame_due, now) + 1.0 / fps
        return False

    def _render_tick(self, snapshot: list[ClientState]) -> None:
        # `snapshot` is taken on the event-loop thread; this method runs in an
        # executor and must not iterate self.clients (mutated on connect/
        # disconnect -> 'dict changed size during iteration').
        self._bind_device()
        t0 = time.perf_counter()
        now_mono = time.monotonic()
        raw = [
            (c, *c.video.latest())
            for c in snapshot
            if c.streaming
        ]
        sources = [(c, f, seq) for c, f, seq, _ in raw if f is not None]
        # frame_age samples only when the frame ADVANCED: re-counting a
        # stale frame every 60 Hz tick inflates the upload->pickup metric
        # with ages that just measure the client's capture cadence (or a
        # paused capture), not pickup latency
        age_seqs: dict[int, int] = {}
        for c, f, seq, ts in raw:
            if f is not None:
                age_seqs[c.id] = seq
                if ts > 0 and self._age_seqs.get(c.id) != seq:
                    self.frame_age.add(max(0.0, now_mono - ts))
        self._age_seqs = age_seqs
        receivers = [c for c in snapshot if c.has_caps]
        if not sources or not receivers:
            return

        sizes = tuple((f.shape[1], f.shape[0]) for _, f, _ in sources)
        hmax = max(f.shape[0] for _, f, _ in sources)
        wmax = max(f.shape[1] for _, f, _ in sources)
        n_src = len(sources)
        # Shape-stabilize the stack at the session high-watermark: padding
        # to the largest layout seen keeps the device stack's shape (and the
        # pinned pool) constant across join/leave and capture-size churn;
        # the compositor plan only ever gathers real rows/pixels, so pad
        # rows are inert zeros. Bounded:
        # n_src <= MAX_CLIENTS, hmax/wmax <= the 800x600 uplink cap
        # (capture.c:41-44) -> worst-case pool 32*600*800*3 = 46 MB, and it
        # only grows to layouts actually served.
        self._stack_hwm = tuple(map(max, (n_src, hmax, wmax),
                                    self._stack_hwm))
        n_src, hmax, wmax = self._stack_hwm
        # pooled source stack: reallocating ~1.4 MB per 60 Hz tick churns
        # pages (the reference's buffer-pool role, lib buffer_pool).
        # Incremental fill: while the layout (shape + membership + sizes)
        # is unchanged, each source owns a constant extent of its row and
        # everything outside it stayed zero from layout creation — only
        # rows whose frame sequence advanced need re-copying (capture runs
        # at ~30 fps under a 60 Hz tick, so typically half the rows skip).
        shape = (n_src, hmax, wmax, 3)
        layout = (shape, tuple(c.id for c, _, _ in sources), sizes)
        fresh_layout = (self._stack_pool is None
                        or self._stack_layout != layout)
        # the last tick's non_blocking row copies may still read the pool
        self._wait_stack_upload()
        if fresh_layout:
            if self._stack_pool is None or tuple(self._stack_pool.shape) != shape:
                self._stack_pool = torch.zeros(
                    shape, dtype=torch.uint8,
                    pin_memory=self.device.type == "cuda")
            else:
                self._stack_pool.fill_(0)
            self._stack_layout = layout
            self._stack_seqs = {}
            self.layout_replans += 1
        stack = self._stack_pool.numpy()  # filled through its numpy view
        changed: list[int] = []
        for i, (c, f, seq) in enumerate(sources):
            if fresh_layout or self._stack_seqs.get(c.id) != seq:
                stack[i, : f.shape[0], : f.shape[1]] = f
                self._stack_seqs[c.id] = seq
                changed.append(i)

        try:
            self._render_tick_device(receivers, sizes, stack,
                                     changed, fresh_layout)
        except Exception:
            # The tick is skipped, never rendered on the host: the work stays
            # on the server's device, and the next tick tries it again. The
            # incremental device stack may be inconsistent (a row copy can
            # die mid-sequence) — drop it; the host pool is always complete,
            # so the next tick re-uploads it. Never quiet: every failure
            # counts on the inspector, and the traceback is logged at ERROR
            # (at most once per 5 s, the tick runs at 60 Hz).
            self._dev_stack = None
            self.device_failures += 1
            if self._fail_rate.should_log("device_tick"):
                log.exception("device render tick failed (%d so far); "
                              "tick skipped", self.device_failures)
        self.ticks += 1
        self._tick_seq = self.ticks  # LRU stamp source for the group cache
        if (self.group_creates != self._trimmed_at_creates
                and time.monotonic() - self._last_gc_trim > 5.0):
            # a group (re)build ran somewhere in this tick: churn windows
            # shed garbage, _tune_latency's raised thresholds let cyclic
            # garbage (stream buffers, dead client graphs) ratchet, and
            # glibc keeps freed arenas mapped. A full collect + trim can
            # blow the deadline for a tick or two, so it is throttled to
            # one pass per 5 s of churn.
            self._trimmed_at_creates = self.group_creates
            self._last_gc_trim = time.monotonic()
            import gc

            gc.collect()
            _malloc_trim()
        dt = time.perf_counter() - t0
        self.tick_latency.add(dt)
        if dt > self._tick_deadline and self._slow_rate.should_log("slow_tick"):
            # SLOW_ASCII_CONVERT analog (stream.c:846-850), against the
            # 16.67 ms render deadline (render.c:4-7)
            log.warning(
                "SLOW_TICK: %.1f ms > %.2f ms deadline — %s", dt * 1e3,
                self._tick_deadline * 1e3,
                self.tick_tracer.breakdown(reset=False, force=True)
                or "no stage data",
            )

    def _upload_stack(self, changed, fresh_layout):
        """Device upload of the pinned source stack — incremental: while the
        layout is unchanged, only rows whose frame advanced are copied
        (``dev_stack[i].copy_(pool[i], non_blocking=True)``, in place on
        the device). At 30 fps capture under the 60 Hz tick this halves the
        upload. A CUDA event after the copies marks when the pool is free to
        refill (:meth:`_wait_stack_upload`)."""
        pool = self._stack_pool
        if (fresh_layout or self._dev_stack is None
                or self._dev_stack.shape != pool.shape):
            self._dev_stack = pool.to(self.device, non_blocking=True, copy=True)
        else:
            for i in changed:
                self._dev_stack[i].copy_(pool[i], non_blocking=True)
        if self.device.type == "cuda":
            self._stack_event = torch.cuda.Event()
            self._stack_event.record()
        return self._dev_stack

    def _wait_stack_upload(self) -> None:
        """Block until the last upload has finished reading the pinned pool."""
        if self._stack_event is not None:
            self._stack_event.synchronize()
            self._stack_event = None

    def _bind_device(self) -> None:
        """Make the server's card current in this (executor) thread."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _render_tick_device(self, receivers, sizes, stack,
                            changed=None, fresh_layout=True) -> None:
        """Production path: ONE render of every geometry group
        (models/server.render_groups — composite gather + per-receiver
        filter + resize + records of all groups in one K3 launch on a CUDA
        device), one fetch, host emission batched per group. Counterpart of
        src/server/stream.c:958 + render.c:340 where the per-client fan-out
        is threads; here it is the batch dimension."""
        from asciichat_tpu_torch.render import emitter

        # desired_fps pacing BEFORE grouping/rendering: a group whose
        # members are all paced out would pay the full device render +
        # fetch at 60 Hz only to discard the result at pack time
        pace_now = time.monotonic()
        receivers = [c for c in receivers
                     if not self._frame_paced_out(c, pace_now)]
        if not receivers:
            return
        groups: dict[tuple, list[ClientState]] = {}
        for c in receivers:
            wc = c.wire_caps
            key = (wc.caps, wc.width, wc.height,
                   _client_palette(wc, self.palette))
            groups.setdefault(key, []).append(c)

        with self.tick_tracer.section("upload"):
            frames_dev = self._upload_stack(
                changed if changed is not None else [], fresh_layout)
        now = time.monotonic()
        # two-phase: render + pack EVERY group first, send only after all
        # succeeded — a late-group failure skips the whole tick rather than
        # serving some clients and not others
        to_send: list[tuple[ClientState, bytes]] = []
        frames_rendered = 0
        compute_count = 0
        # Dispatch phase: resolve every group, then render them all with one
        # call (on a CUDA device one K3 launch over every group's tiles, one
        # per shard on a mesh, each group's records in the server's arena). The "convert" tracer
        # section therefore measures the launch only; the device-compute
        # wait lands in the one blocked "fetch".
        staged: list[tuple] = []  # (grp, members, member_slot, n_uniq)
        for key, members in groups.items():
            wc0 = members[0].wire_caps
            # identical receivers (same filter within the same geometry
            # group) share ONE rendered frame — the device batch covers the
            # UNIQUE filters, the fan-out is host-side byte reuse (the
            # reference's per-client render cache, stream.c rendered-once
            # semantics)
            unique_filters: list[str] = []
            member_slot: list[int] = []
            for m in members:
                if m.filter_name not in unique_filters:
                    unique_filters.append(m.filter_name)
                member_slot.append(unique_filters.index(m.filter_name))
            # the padded stack's shape is part of the key: a group's maps
            # are checked against the stack it reads
            cache_key = (sizes, self._stack_hwm, key, len(unique_filters))
            grp = self._group_cache.get(cache_key)
            if grp is None:
                if len(self._group_cache) >= GROUP_CACHE_MAX:
                    # LRU eviction, not clear-all: geometry/layout churn
                    # (live resizes, churn joins) must neither wipe the hot
                    # serving groups nor ratchet dead groups' device buffers.
                    # An evicted group still staged this tick stays alive
                    # via its `staged` reference until drained; its records
                    # live in the server's arena, not in the group.
                    stale = sorted(self._group_cache,
                                   key=lambda k: self._group_last_used.get(k, 0))
                    for k in stale[: len(stale) - GROUP_CACHE_MAX + 1]:
                        self._group_cache.pop(k, None)
                        self._group_last_used.pop(k, None)
                grp = RenderGroup(
                    list(sizes), wc0.width, wc0.height, wc0.caps,
                    unique_filters, key[3],  # the resolved client palette
                    device=self.device, mesh=self.mesh,
                )
                self._group_cache[cache_key] = grp
                self.group_creates += 1
            elif grp.filter_names != unique_filters:
                grp.set_filters(unique_filters)
            self._group_last_used[cache_key] = self._tick_seq
            staged.append((grp, members, member_slot, len(unique_filters)))
        with self.tick_tracer.section("convert"):
            records = render_groups(frames_dev, [s[0] for s in staged], now,
                                    self._arena)
        if self.mesh is not None:
            # the render's copies of the stack to the mesh's other devices
            self.mesh_collectives = self._arena.copies
        with self.tick_tracer.section("fetch"):
            hosts = self._arena.fetch(records)  # one copy, the arena's pinned buffer
        # Drain phase: emit and pack group by group.
        for (grp, members, member_slot, n_uniq), host in zip(staged, hosts):
            with self.tick_tracer.section("emit"):
                views = emitter.emit_frames(
                    host, grp.render.mode, grp.palette,
                    pad_w=grp.render.pad_w, pad_h=grp.render.pad_h, copy=False,
                )
            # per-slot packing cache: compress once per unique rendered frame
            packed: dict[tuple[int, bool], bytes] = {}
            with self.tick_tracer.section("pack"):
                for i, c in enumerate(members):
                    no_compress = bool(c.wire_caps.capabilities_mask & 0x1)
                    pk = (member_slot[i], no_compress)
                    payload = packed.get(pk)
                    if payload is None:
                        payload = packed[pk] = pkt.pack_ascii_frame(
                            bytes(views[member_slot[i]]), c.wire_caps.width,
                            c.wire_caps.height, compress=not no_compress,
                            level=self.compression_level,
                        )
                    to_send.append((c, payload))
            frames_rendered += n_uniq
            compute_count += 1
        with self.tick_tracer.section("send"):
            for c, payload in to_send:
                # stale ASCII frames are worthless to a stalled reader:
                # shed past ~3 frames' worth of backlog (latest-wins, same
                # rationale as the client's video uplink byte_cap)
                if c.transport.send_nowait(pkt.PacketType.ASCII_FRAME, payload,
                                           byte_cap=max(1 << 19, 4 * len(payload))):
                    self.stats.frames_sent += 1
                    self.stats.bytes_sent += len(payload)
        self.stats.frames_rendered += frames_rendered
        self.tick_compute_count += compute_count

    # ------------------------------------------------------------------
    # Audio tick: exclude-self mixes for everyone in one batched op

    def _audio_tick(self, snapshot: list[ClientState]) -> None:
        # runs in an executor (a device wait must not stall the event loop);
        # iterates the snapshot, not self.clients
        n = audio_ops.AUDIO_FRAME_SAMPLES
        speakers = [c for c in snapshot if len(c.audio) >= n]
        listeners = [c for c in snapshot if c.has_caps]
        if not speakers or not listeners:
            return
        t0 = time.perf_counter()
        self._bind_device()
        slots = [c.id for c in snapshot]
        samples_t, active_t, mixes_t = self._audio_buffers(len(slots), n)
        samples, active = samples_t.numpy(), active_t.numpy()
        samples.fill(0.0)
        active.fill(False)
        # latest-audio-wins latency bound (consumer-side shedding): the
        # SPSC ring truncates NEW writes when full, so a network burst that
        # once filled a client's ring would otherwise play ~1.4 s late
        # FOREVER (the tick only drains 480 samples per 10 ms). Cap the
        # backlog at ~4 frames and discard the oldest surplus.
        max_backlog = 4 * n
        for i, c in enumerate(snapshot):
            excess = len(c.audio) - max_backlog
            if excess > 0:
                c.audio.read(excess)
            if len(c.audio) >= n:
                samples[i] = c.audio.read(n)
                active[i] = True
        stream = self._audio_stream
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if slots != self.mixer_slots or self.mixer_state is None:
                self.mixer_slots = slots
                self.mixer_state = audio_ops.MixerState.init(
                    len(slots), len(slots), self.device).astuple()
            mixes, self.mixer_state = audio_ops.mixer_process(
                samples_t.to(self.device, non_blocking=True),
                active_t.to(self.device, non_blocking=True), self.mixer_state)
            mixes_t.copy_(mixes, non_blocking=True)
        if stream is not None:
            stream.synchronize()  # the mixes are in mixes_t; the buffers are free
        mixes = mixes_t.numpy()
        for i, c in enumerate(snapshot):
            if not c.has_caps:
                continue
            if c.wire_caps.codec_audio == 1 and c.opus is None:
                # listen-only opus clients (codec_audio caps, no mic) never
                # hit the uplink handler that lazily creates the context —
                # create it on the DOWNLINK side too, else they get raw
                # float32 at ~1.5 Mbps instead of the negotiated codec
                from asciichat_tpu_torch.runtime import codecs

                try:
                    new = codecs.OpusCodec()
                    if c.opus is None:  # uplink handler may have raced us
                        c.opus = new
                    else:
                        new.close()
                except codecs.CodecUnavailable:
                    c.opus = False
            if c.wire_caps.codec_audio == 1 and c.opus:
                # opus client: encode its personalized mix with ITS context
                try:
                    payload = pkt.pack_audio_batch(c.opus.encode(mixes[i]), n, 1)
                    c.transport.send_nowait(pkt.PacketType.AUDIO_OPUS_BATCH, payload)
                    continue
                except ValueError:
                    pass  # fall through to raw
            payload = pkt.pack_audio_batch(
                mixes[i].astype("<f4").tobytes(), n, 1
            )
            c.transport.send_nowait(pkt.PacketType.AUDIO_BATCH, payload)
        self.audio_latency.add(time.perf_counter() - t0)

    def _audio_buffers(self, s: int, n: int) -> tuple[torch.Tensor, ...]:
        """The audio tick's host buffers (samples f32 [s, n], active bool
        [s], mixes f32 [s, n]), pinned on a CUDA device and reused while the
        slot count holds; each tick synchronises before it reuses them."""
        bufs = self._audio_host
        if bufs is None or tuple(bufs[0].shape) != (s, n):
            pin = self.device.type == "cuda"
            bufs = self._audio_host = (
                torch.zeros((s, n), dtype=torch.float32, pin_memory=pin),
                torch.zeros(s, dtype=torch.bool, pin_memory=pin),
                torch.zeros((s, n), dtype=torch.float32, pin_memory=pin))
        return bufs

    # ------------------------------------------------------------------

    async def _audio_loop(self) -> None:
        """Independent 100 Hz audio cadence (render.c:42 dedicated audio
        thread): awaiting the video render inline ahead of the audio tick
        meant any slow render (worst: the first kernel build, seconds)
        silenced audio for everyone."""
        loop = asyncio.get_running_loop()
        next_audio = loop.time()
        while True:
            now = loop.time()
            if now >= next_audio:
                try:
                    snapshot = list(self.clients.values())
                    await loop.run_in_executor(None, self._audio_tick, snapshot)
                except Exception:
                    self.audio_failures += 1
                    log.exception("audio tick failed")
                next_audio = max(next_audio + AUDIO_TICK, now)
            await asyncio.sleep(max(0.0, next_audio - loop.time()))

    async def _tick_loop(self) -> None:
        loop = asyncio.get_running_loop()
        audio_task = loop.create_task(self._audio_loop())
        try:
            await self._video_loop()
        finally:
            audio_task.cancel()

    async def _video_loop(self) -> None:
        loop = asyncio.get_running_loop()
        next_video = loop.time()
        next_stats = loop.time() + 30.0
        next_sweep = loop.time() + 5.0
        next_maint = loop.time() + MAINT_INTERVAL_S
        while True:
            now = loop.time()
            if now >= next_video:
                try:
                    snapshot = list(self.clients.values())
                    await loop.run_in_executor(None, self._render_tick, snapshot)
                except Exception:
                    log.exception("render tick failed")
                next_video = max(next_video + VIDEO_TICK, now)
            if now >= next_stats:
                lat = self.tick_latency.stats_ms()
                log.info("stats: %s tick_latency p50=%.2fms p99=%.2fms "
                         "worst=%.1fms deadline=%.2fms",
                         self.stats.report(len(self.clients)),
                         lat["p50_ms"], lat["p99_ms"], lat["worst_ms"],
                         self._tick_deadline * 1e3)
                next_stats = now + 30.0
            if now >= next_sweep:
                await self._sweep_stalled()
                next_sweep = now + 5.0
            if now >= next_maint:
                # periodic memory maintenance: _tune_latency's raised gc
                # thresholds let cyclic garbage (stream buffers, dead client
                # graphs) ratchet under sustained load, and glibc keeps
                # freed arenas mapped. One full collect per
                # MAINT_INTERVAL_S may blow one 16.67 ms tick out of ~1200.
                import gc

                gc.collect()
                _malloc_trim()
                next_maint = now + MAINT_INTERVAL_S
            await asyncio.sleep(max(0.0, next_video - loop.time()))

    async def _sweep_stalled(self) -> None:
        """Probe quiet clients, disconnect silent ones (see CLIENT_TIMEOUT_S)."""
        now = time.monotonic()
        probe_after = min(PING_PROBE_S, self.client_timeout / 3)
        async def _close_one(cl):
            with contextlib.suppress(Exception):
                await cl.transport.close()  # recv loop unwinds + cleans up

        doomed = []
        for c in list(self.clients.values()):
            silent = now - c.last_seen
            if silent > self.client_timeout:
                log.warning("client %d silent for %.0fs; disconnecting", c.id,
                            silent)
                doomed.append(c)
            elif silent > probe_after:
                c.transport.send_nowait(pkt.PacketType.PING, b"probe")
        if doomed:
            # CONCURRENT and detached: each bounded close can still take
            # 2-4 s against a zero-window peer, and awaiting them serially
            # inside the video loop froze rendering for every healthy
            # client by 2-4 s PER dead client during a partition
            task = asyncio.gather(*(_close_one(c) for c in doomed))
            self._sweep_task = task  # strong ref; gather never raises here

    def _tune_latency(self) -> None:
        """Deadline-oriented runtime tuning (render.c:4-7 leaves no room for
        stop-the-world pauses; the reference is collector-free C).

        - gc: freeze the post-startup object graph out of collection scans
          and raise generation thresholds: an untuned gen-2 collection can
          pause the render tick far past the 16.67 ms deadline (worst_ms in
          tick_latency).
          ASCIICHAT_GC=off disables cyclic gc entirely (refcounting still
          frees everything acyclic); =default leaves CPython alone.
        - GIL switch interval 1 ms: the tick executor thread must not wait
          5 ms (CPython default) behind event-loop bytecode to start.
        """
        import gc
        import os as _os
        import sys as _sys

        mode = _os.environ.get("ASCIICHAT_GC", "tuned")
        if mode == "off":
            gc.collect()
            gc.disable()
        elif mode == "tuned":
            gc.collect()
            gc.freeze()
            gc.set_threshold(50_000, 50, 50)
        _sys.setswitchinterval(0.001)

    async def run(self) -> None:
        # warm the codec probes and the CUDA kernels in an executor: the
        # first call may compile native/avshim.cpp and open an x265 thread
        # pool, or build the kernels with nvcc (seconds), and must never
        # block the event loop or stall the first ticks
        from asciichat_tpu_torch.runtime.codecs import probe_h265_encoder, probe_video_codecs

        def _warm():
            if self.device.type == "cuda":
                from asciichat_tpu_torch.runtime.kernel_build import cuda_lib

                cuda_lib()
            if "h265" in probe_video_codecs():
                enc = probe_h265_encoder()
                log.info("h265 encoder negotiated: %s", enc or "none")

        await asyncio.get_running_loop().run_in_executor(None, _warm)
        self._tune_latency()
        self._server = await serve_tcp(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # port 0: the bound one
        log.info("listening on %s:%d (tcp)", self.host, self.port)
        ws_server = None
        webrtc_gw = None
        if self.ws_port:
            from asciichat_tpu_torch.apps.webclient import WebRtcGateway, make_http_handler
            from asciichat_tpu_torch.net.websocket import serve_ws

            webrtc_gw = WebRtcGateway(self._handle_conn)
            post = None
            if webrtc_gw.available():
                def post(path, body, _gw=webrtc_gw):
                    route = path.split("?", 1)[0]
                    if route == "/webrtc/offer":
                        return _gw.on_offer(body)
                    if route == "/webrtc/candidate":  # trickle ICE
                        return _gw.on_candidate(path, body)
                    return None
            ws_server = await serve_ws(self._handle_conn, self.host, self.ws_port,
                                       pages=make_http_handler(), post=post)
            log.info("listening on %s:%d (websocket + browser client page%s)",
                     self.host, self.ws_port,
                     " + webrtc signaling" if post else "")
        announcer = None
        if self.mdns:
            from asciichat_tpu_torch.net.mdns import MdnsAnnouncer

            announcer = MdnsAnnouncer("asciichat", self.port,
                                      {"ver": "1", "ws": str(self.ws_port or 0)})
            announcer.start()
            log.info("mDNS announcing _asciichat._tcp.local")
        insp = None
        if self.inspect_port is not None:
            from asciichat_tpu_torch.runtime.inspector import Inspector

            insp = Inspector(self.inspect_port)
            insp.register("server", self.server_state)
            insp.register("logs", lambda: ring_log.tail(100))
            from asciichat_tpu_torch.utils import syncdebug

            insp.register("sync", syncdebug.dump_state)
            actual = insp.start()
            log.info("inspector on http://127.0.0.1:%d", actual)
        tick = asyncio.get_running_loop().create_task(self._tick_loop())
        status_task = None
        if self.status_screen:
            status_task = asyncio.get_running_loop().create_task(self._status_loop())
        try:
            await self._server.serve_forever()
        finally:
            tick.cancel()
            if status_task:
                status_task.cancel()
            if ws_server:
                ws_server.close()
            if webrtc_gw:
                webrtc_gw.close()
            if announcer:
                announcer.stop()
            if insp:
                insp.stop()

    def server_state(self) -> dict:
        """The inspector's ``/state/server`` record."""
        return {
            "clients": len(self.clients),
            "ticks": self.ticks,
            "tick_compute": self.tick_compute_count,
            "device": str(self.device),
            "device_failures": self.device_failures,
            "audio_failures": self.audio_failures,
            # launches of K3 and K4 in this process, counted by their wrappers
            "render_launches": RENDER_GROUP_KERNEL.launches,
            "mixer_launches": audio_ops.MIXER_KERNEL.launches,
            "mesh": self.mesh.shape if self.mesh is not None else None,
            "mesh_collectives": self.mesh_collectives,
            "tick_latency": self.tick_latency.stats_ms(),
            "audio_tick_latency": self.audio_latency.stats_ms(),
            "frame_age": self.frame_age.stats_ms(),
            "tick_deadline_ms": round(self._tick_deadline * 1e3, 2),
            "tick_stages_ms": {
                k: round(t / max(n, 1) * 1e3, 3)
                for k, (t, n) in self.tick_tracer.snapshot().items()
            },
            "client_ids": list(self.clients),
            "stats": self.stats.report(len(self.clients)),
        }

    async def _status_loop(self) -> None:
        """Status screen with live log feed on the server's own terminal
        (lib/ui/status.c ui_status_display at the display rate)."""
        import shutil as _shutil

        from asciichat_tpu_torch.utils import term as term_mod
        from asciichat_tpu_torch.utils.ui import StatusScreen

        size = _shutil.get_terminal_size(fallback=(80, 24))
        screen = StatusScreen(
            "server",
            lambda: {
                "listen": f"{self.host}:{self.port}"
                          + (f" ws:{self.ws_port}" if self.ws_port else ""),
                "clients": f"{len(self.clients)}/{MAX_CLIENTS}",
                "tick": f"{self.ticks} ({self.device})",
                "stats": self.stats.report(len(self.clients)),
            },
            width=size.columns, height=size.lines - 1,
        )
        writer = term_mod.FrameWriter()
        writer.setup()
        try:
            while True:
                writer.write_frame(screen.render())
                await asyncio.sleep(0.25)
        finally:
            writer.teardown()


def main(args) -> int:
    import sys as _sys

    if args.password or args.allowed_keys or args.gpg_keyring:
        # authentication needs the crypto handshake, which needs
        # `cryptography`: without it, refuse to start rather than serve
        # plaintext
        try:
            import cryptography  # noqa: F401

            from asciichat_tpu_torch.net import crypto, handshake  # noqa: F401
        except ImportError as e:
            print("error: --password, --allowed-keys and --gpg-keyring need the "
                  f"`cryptography` package, which cannot be imported ({e})",
                  file=_sys.stderr)
            return 1
    allowed = None
    if args.allowed_keys:
        # file path OR forge specs ('github:alice,gitlab:bob' fetched over
        # HTTPS — lib/crypto/https_keys.c role, net/httpskeys.py)
        from asciichat_tpu_torch.net.httpskeys import load_allowed_keys

        allowed = load_allowed_keys(args.allowed_keys)
        log.info("SSH client auth required (%d allowed key(s))", len(allowed))
    gpg_keyring = None
    if args.gpg_keyring:
        from asciichat_tpu_torch.net.gpgauth import GpgKeyring

        gpg_keyring = GpgKeyring(args.gpg_keyring)
        log.info("GPG client auth required (keyring %s)", args.gpg_keyring)
    host_identity = None
    if allowed is not None or gpg_keyring is not None:
        import os as _os2

        from asciichat_tpu_torch.net.identity import Identity

        key_path = _os2.path.expanduser(
            _os2.environ.get("ASCIICHAT_HOST_KEY", "~/.asciichat/host_key"))
        try:
            host_identity = Identity.load_or_create(key_path)
            log.info("host identity %s (known_hosts pinning)",
                     host_identity.id_hex[:16])
        except (OSError, ValueError) as e:
            # ValueError = corrupt/truncated key file: serve with an
            # ephemeral identity rather than crash-loop at startup
            log.warning("host key %s unavailable (%s); using an ephemeral "
                        "identity for this run", key_path, e)
    server = AsciiChatServer(args.host, args.port,
                             palette=pal.BUILTIN_PALETTES.get(args.palette,
                                                              args.palette),
                             compression_level=args.compress,
                             password=args.password, ws_port=args.ws_port,
                             mdns=args.mdns, inspect_port=args.inspect_port,
                             status_screen=args.status and _sys.stdout.isatty(),
                             allowed_keys=allowed, gpg_keyring=gpg_keyring,
                             host_identity=host_identity)
    try:
        asyncio.run(server.run())
    except KeyboardInterrupt:
        pass
    return 0
