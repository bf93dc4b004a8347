"""ascii-chat client: connect, stream media up, display ASCII frames.

The port's copy of ``asciichat_tpu/apps/client.py``, without JAX. Mirrors
src/client/: connect with reconnect/backoff (README "auto-reconnect"), report
capabilities (src/client/protocol.c), capture task sending <=800x600 RGB
IMAGE_FRAMEs at a capped rate (src/client/capture.c:30-50), audio capture as
AUDIO_BATCH, receive loop displaying ASCII_FRAMEs with full reset on first
frame (src/client/display.c) + keepalive ping (src/client/keepalive.c).

The one piece of device work is the audio capture chain (echo canceller,
highpass, noise gate: ``ops/audio.ClientAudioPipeline``, K5 on the card),
built only when the client has an audio source, on
``runtime/device.default_device()`` unless a device is given: a client
without audio needs no card. Transport is TCP, WebSocket with ``use_ws``
(``--ws``, ``net/websocket.py``) or a WebRTC DataChannel with ``use_webrtc``
(``--webrtc``, ``net/datachannel.connect_webrtc`` against the server's
``/webrtc/offer``). ``--browse`` lists the servers announced over mDNS
(``net/mdns.py``). ``net/crypto.py`` and
``net/handshake.py`` (which need ``cryptography``) are imported only for an
encrypted session, and ``net/crypto.py`` for a WebRTC one.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from asciichat_tpu_torch.models.session import (
    DisplaySink, FrameTransform, Pacer, ReconnectPolicy,
)
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import protocol as proto
from asciichat_tpu_torch.net.transport import Transport, connect_tcp
from asciichat_tpu_torch.runtime.framesource import FrameSource
from asciichat_tpu_torch.utils import term
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("client")


class ServerError(Exception):
    """Terminal server-reported error (ERROR_MESSAGE packet): SERVER_FULL,
    bad-data disconnect, ... Raised from run() instead of exiting cleanly —
    a refused client must be observable to its caller (the reference client
    prints the error packet and exits non-zero). Deliberately NOT a
    ConnectionError: run()'s reconnect handler must never retry it."""

    def __init__(self, code: int, msg: str):
        super().__init__(f"server error {code}: {msg}")
        self.code = code
        self.msg = msg

CAPTURE_FPS_CAP = 144  # src/client/capture.c:33
MAX_UPLOAD_W, MAX_UPLOAD_H = 800, 600  # capture.c:41-44
KEEPALIVE_INTERVAL = 5.0


class AsciiChatClient:
    def __init__(
        self,
        host: str,
        port: int,
        source: FrameSource | None = None,
        wire_caps: proto.WireCapabilities | None = None,
        capture_fps: float = 30.0,
        reconnect: bool = True,
        encrypt: bool = False,
        password: str | None = None,
        flip_x: bool = False,
        flip_y: bool = False,
        show_fps: bool = False,
        audio_source=None,
        audio_sink=None,
        want_h265: bool = False,
        audio_gain: float = 1.0,
        ssh_identity=None,
        gpg_identity=None,
        use_opus: bool = False,
        device=None,
        use_ws: bool = False,
        use_webrtc: bool = False,
    ):
        self.host = host
        self.port = port
        self.use_ws = use_ws
        self.use_webrtc = use_webrtc
        self.source = source
        self.wire_caps = wire_caps or proto.WireCapabilities()
        self.capture_fps = min(capture_fps, CAPTURE_FPS_CAP)
        # single source: the policy object gates retries (its `enabled` was
        # previously stored-but-never-read while a duplicate flag decided)
        self.reconnect = reconnect  # kept as the public constructor mirror
        self.encrypt = encrypt
        self.password = password
        self.ssh_identity = ssh_identity  # sshauth.SshIdentity | None
        self.gpg_identity = gpg_identity  # gpgauth.GpgIdentity | None
        # shared session framework (models/session.py, src/common/session/):
        # capture transforms + display + reconnect policy are the same
        # implementations the mirror and discovery modes use
        self.transform = FrameTransform(flip_x=flip_x, flip_y=flip_y,
                                        max_upload=(MAX_UPLOAD_W, MAX_UPLOAD_H))
        self.display = DisplaySink(show_fps=show_fps)
        # from self.wire_caps (never None — defaults applied above), not the
        # constructor arg: gating on the arg left the fps status line empty
        # for callers using the default capabilities
        self.display.set_meta(self.wire_caps.caps.renderer_key(),
                              (self.wire_caps.width, self.wire_caps.height))
        self.reconnect_policy = ReconnectPolicy(enabled=reconnect)
        self.frames_received = 0
        self.frames_sent = 0
        # Audio duplex (src/client/audio.c:276 capture, :531 playback):
        # capture frames run the DSP pipeline (AEC vs received playback,
        # highpass, gate) before leaving as AUDIO_BATCH.
        self.audio_source = audio_source
        self.audio_sink = audio_sink
        self.audio_gain = audio_gain  # capture gain applied before send
        self.audio_pipeline = None
        # Opus codec (real libopus via ctypes, lib/audio/opus.c analog):
        # requested with use_opus; both directions run one context each
        self.opus_enc = self.opus_dec = None
        if use_opus:
            from asciichat_tpu_torch.runtime import codecs

            try:
                # ONE instance: it already holds both native contexts
                # (~45 KB each of gc-invisible memory); two instances
                # wasted half of them
                self.opus_enc = self.opus_dec = codecs.OpusCodec()
                self.wire_caps.codec_audio = 1
            except codecs.CodecUnavailable as e:
                log.warning("opus requested but unavailable (%s); raw PCM", e)
        if audio_source is not None:
            # the capture chain on the card (K5), unless the caller or
            # ASCIICHAT_TORCH_DEVICE names the CPU
            from asciichat_tpu_torch.ops.audio import ClientAudioPipeline

            self.audio_pipeline = ClientAudioPipeline(device=device)
        self.audio_frames_sent = 0
        self.audio_failures = 0  # frames the capture chain failed on (skipped)
        self.audio_frames_received = 0
        # H.265 uplink: requested by the user, activated only once the server
        # advertises a decoder in SERVER_STATE (capability negotiation;
        # lib/video/h265/encoder.c + session/h265/server.c). Falls back to
        # raw RGB IMAGE_FRAME otherwise.
        self.want_h265 = want_h265
        self.h265_active = False
        self._h265_enc = None
        self.h265_frames_sent = 0
        self._stop = asyncio.Event()
        self._server_error: tuple[int, str] | None = None
        self._loop: asyncio.AbstractEventLoop | None = None  # set in run()
        self._password_key: bytes | None = None  # Argon2id cache (reconnects)
        self._last_rx = time.monotonic()

    async def _capture_task(self, t: Transport) -> None:
        if self.source is None:
            return
        pacer = Pacer(self.capture_fps)  # fps=0 means uncapped
        loop = asyncio.get_running_loop()
        while not self._stop.is_set():
            t0 = loop.time()
            try:
                frame = await loop.run_in_executor(None, self.source.read)
            except Exception as e:
                log.warning("video capture ended: %s", e)
                t.send_nowait(pkt.PacketType.STREAM_STOP)
                return
            if frame is None:
                # end of stream: tell the server to remove our tile — the
                # STREAM_START at session setup otherwise left viewers
                # looking at our last frame frozen in the grid forever
                t.send_nowait(pkt.PacketType.STREAM_STOP)
                break
            try:
                frame = self.transform(frame)
            except Exception:
                # a transient transform failure (filter math on a torn
                # frame) must skip the frame, not kill the uplink for the
                # rest of a possibly hours-long session
                log.exception("frame transform failed; frame skipped")
                continue
            if not self.h265_active and self._h265_enc is not None:
                # the capture task is the encoder's sole owner: the recv
                # loop only flips h265_active (closing here, between
                # encodes, avoids freeing the native context under a
                # concurrent executor encode)
                enc, self._h265_enc = self._h265_enc, None
                await loop.run_in_executor(None, enc.close)
            if self.h265_active:
                # x265 encode is 5-15 ms per frame: inline it and the event
                # loop stalls every frame, starving the 10 ms audio capture
                # cadence in this same process (observed: the uplink tone
                # turns to gaps/silence on a 1-core host the moment --h265
                # switches on). Encode in the executor; send_nowait is
                # thread-safe like the server's tick sends.
                await loop.run_in_executor(None, self._send_h265, t, frame)
            else:
                payload = pkt.pack_image_frame(
                    frame.tobytes(), frame.shape[1], frame.shape[0]
                )
                # Latest-wins shedding: at most ~2 raw frames may wait in
                # the queue (the reference's video path is a latest-frame
                # double-buffer, video_frame.c:214-264 — never a backlog).
                # Without this the 256-packet queue bound admits ~226 MB
                # of stale video per client whenever the server or link
                # stalls; a frame the peer would render seconds late is
                # better dropped at capture (pipeline.c:72-80).
                t.send_nowait(pkt.PacketType.IMAGE_FRAME, payload,
                              byte_cap=max(1 << 20, 3 * len(payload)))
            self.frames_sent += 1
            await asyncio.sleep(pacer.sleep_for(t0, loop.time()))

    def _send_h265(self, t: Transport, frame: np.ndarray) -> None:
        """Encode + ship one frame as IMAGE_FRAME_H265 access units; any
        failure drops back to raw RGB for the rest of the session."""
        from asciichat_tpu_torch.runtime import codecs

        h, w = frame.shape[:2]
        try:
            if self._h265_enc is None or (self._h265_enc.width,
                                          self._h265_enc.height) != (w, h):
                if self._h265_enc is not None:
                    self._h265_enc.close()
                self._h265_enc = codecs.H265Encoder(w, h, fps=int(self.capture_fps))
            for au in self._h265_enc.encode(frame):
                payload = pkt.pack_image_frame(au, w, h, pkt.PIXEL_FORMAT_HEVC)
                t.send_nowait(pkt.PacketType.IMAGE_FRAME_H265, payload)
                self.h265_frames_sent += 1
        except (codecs.CodecUnavailable, OSError, BrokenPipeError,
                ValueError) as e:
            # ValueError = native encode error (avcodec_send_frame -1):
            # without catching it here, one transient encoder failure
            # killed the whole capture task and video stopped for the
            # session instead of falling back as this docstring promises
            log.warning("h265 uplink failed (%s); falling back to raw RGB", e)
            self.h265_active = False
            enc, self._h265_enc = self._h265_enc, None
            if enc is not None:
                try:
                    enc.close()  # dropping without close leaked the native
                    #              context / ffmpeg child until exit
                except Exception:
                    pass

    async def _audio_capture_task(self, t: Transport) -> None:
        """10 ms cadence: read a 480-sample frame, run the client DSP
        pipeline, ship it as AUDIO_BATCH (src/client/audio.c:276-350)."""
        if self.audio_source is None:
            return
        from asciichat_tpu_torch.ops.audio import AUDIO_FRAME_SAMPLES, SAMPLE_RATE

        n = AUDIO_FRAME_SAMPLES
        pacer = Pacer(SAMPLE_RATE / n)  # the 10 ms frame cadence
        loop = asyncio.get_running_loop()
        while not self._stop.is_set():
            t0 = loop.time()
            try:
                frame = await loop.run_in_executor(None, self.audio_source.read, n)
            except Exception as e:
                log.warning("audio capture ended: %s", e)
                return
            try:
                processed = await loop.run_in_executor(
                    None, self.audio_pipeline.process, frame
                )
            except Exception:
                # counted, never retried on another path: a run can require 0
                self.audio_failures += 1
                log.exception("audio pipeline failed; frame skipped")
                continue
            if self.audio_gain != 1.0:
                processed = np.clip(processed * self.audio_gain, -1.0, 1.0)
            if self.opus_enc is not None:
                try:
                    payload = pkt.pack_audio_batch(
                        self.opus_enc.encode(np.asarray(processed, np.float32)),
                        n, 1)
                except ValueError as e:
                    # transient encode failure must not kill the audio task
                    log.warning("opus encode failed (%s); frame skipped", e)
                    continue
                t.send_nowait(pkt.PacketType.AUDIO_OPUS_BATCH, payload)
            else:
                payload = pkt.pack_audio_batch(
                    np.asarray(processed, "<f4").tobytes(), n, 1
                )
                t.send_nowait(pkt.PacketType.AUDIO_BATCH, payload)
            self.audio_frames_sent += 1
            await asyncio.sleep(pacer.sleep_for(t0, loop.time()))

    async def send_text(self, t, message: str) -> None:
        """Text chat (PACKET_TYPE_TEXT_MESSAGE, relayed by the server)."""
        await t.send(pkt.PacketType.TEXT_MESSAGE, message.encode()[:1000])

    async def _keepalive_task(self, t: Transport) -> None:
        while not self._stop.is_set():
            await asyncio.sleep(KEEPALIVE_INTERVAL)
            # dead-link detection (keepalive.c role, BOTH directions): a
            # path that drops without RST leaves recv() blocked forever —
            # the server pings us and streams frames, so prolonged silence
            # means the link is gone; closing the transport unwinds the
            # recv loop into the reconnect path instead of hanging until
            # the OS TCP timeout (~15+ min)
            # monotonic, not wall-clock: an NTP step forward instantly
            # 'aged' a healthy session past the threshold and dropped it
            if time.monotonic() - self._last_rx > 3 * KEEPALIVE_INTERVAL + 5:
                log.warning("server silent for %.0fs; dropping dead link",
                            time.monotonic() - self._last_rx)
                await t.close()
                return
            t.send_nowait(pkt.PacketType.PING, str(time.time()).encode())

    async def _recv_loop(self, t: Transport, max_frames: int | None) -> None:
        P = pkt.PacketType
        while not self._stop.is_set():
            ptype, payload = await t.recv()
            self._last_rx = time.monotonic()
            if ptype == P.ASCII_FRAME:
                frame, _w, _h, _flags = pkt.unpack_ascii_frame(payload)
                self.display.write_frame(frame)
                self.frames_received += 1
                if max_frames and self.frames_received >= max_frames:
                    self._stop.set()
            elif ptype == P.CLEAR_CONSOLE:
                self.display.reset()
            elif ptype == P.PONG:
                pass
            elif ptype == P.SERVER_STATE:
                # codec negotiation: enable the H.265 uplink only when the
                # server advertises a decoder (falls back to raw otherwise)
                if self.want_h265 and not self.h265_active:
                    import json

                    try:
                        codecs_adv = json.loads(payload).get("codecs", [])
                    except (ValueError, AttributeError):
                        # valid-but-non-dict JSON (a list) raised
                        # AttributeError past run()'s reconnect catches
                        codecs_adv = []
                    if isinstance(codecs_adv, list) and "h265" in codecs_adv:
                        self.h265_active = True
                        log.info("server supports h265: switching uplink")
            elif ptype == P.AUDIO_OPUS_BATCH:
                if self.opus_dec is not None:
                    body, _bc, total, _rate, _ch = pkt.unpack_audio_batch(payload)
                    try:
                        mix = self.opus_dec.decode(body)[:total]
                    except ValueError:
                        continue
                    self.audio_frames_received += 1
                    if self.audio_sink is not None:
                        self.audio_sink.write(mix)
                    if self.audio_pipeline is not None:
                        self.audio_pipeline.add_far(mix)
            elif ptype == P.AUDIO_BATCH:
                # playback: exclude-self server mix -> sink; the played
                # signal is also the AEC far-end reference
                # (src/client/audio.c:531 playback thread)
                body, _bc, total, _rate, _ch = pkt.unpack_audio_batch(payload)
                mix = np.frombuffer(body, "<f4")[:total]
                self.audio_frames_received += 1
                if self.audio_sink is not None:
                    self.audio_sink.write(mix)
                if self.audio_pipeline is not None:
                    self.audio_pipeline.add_far(mix)
            elif ptype == P.TEXT_MESSAGE:
                # chat line below the frame (client text chat)
                self.display.chat_line(payload)
            elif ptype == P.ERROR_MESSAGE:
                code, msg = proto.unpack_error(payload)
                if code == proto.WireError.CODEC_UNAVAILABLE:
                    # server cannot decode our H.265 uplink: fall back to
                    # raw RGB instead of dying (capability mismatch is
                    # recoverable; the session continues). The server sends
                    # one error per in-flight H.265 frame, so DUPLICATES
                    # arriving after the fallback must be ignored — gating
                    # on h265_active sent the second error down the fatal
                    # branch and killed the client mid-fallback. The
                    # encoder is owned by the capture task (it may be
                    # mid-encode in an executor thread right now): only
                    # flip the flag here; the capture loop closes it.
                    if self.h265_active:
                        log.warning("server refused h265 (%s); "
                                    "raw RGB fallback", msg)
                        self.h265_active = False
                        # LATCH: the server's refusal is per-session final
                        # (it stops even answering after its own latch) —
                        # without clearing want_h265, the next SERVER_STATE
                        # broadcast re-enabled the uplink and every frame
                        # streamed into a void for the rest of the session
                        self.want_h265 = False
                    else:
                        log.debug("repeated h265 refusal ignored: %s", msg)
                else:
                    # TERMINAL server-reported error (SERVER_FULL, bad-data
                    # disconnect...): record it so run() can surface it —
                    # swallowing it into a clean stop made a refused client
                    # indistinguishable from a finished one (the reference
                    # client prints the error packet and exits non-zero,
                    # README.md:305-313 error semantics)
                    log.error("server error %d: %s", code, msg)
                    self._server_error = (int(code), msg)
                    self._stop.set()

    async def _dial(self):
        if self.use_webrtc:
            # WebRTC transport (src/client/webrtc.c role): SDP signaling
            # against the server's /webrtc/offer + ICE/DTLS/SCTP; the
            # server sees this client exactly like a browser
            from asciichat_tpu_torch.net.datachannel import connect_webrtc

            return await connect_webrtc(self.host, self.port)
        if self.use_ws:
            from asciichat_tpu_torch.net.websocket import connect_ws

            return await connect_ws(self.host, self.port)
        return await connect_tcp(self.host, self.port)

    async def _session(self, max_frames: int | None) -> None:
        # initial-dial retry ladder (lib/network/connection_attempt.c role):
        # a refused/reset FIRST dial retries briefly even with
        # --no-reconnect — that flag governs post-session behavior, not a
        # SYN racing a server's momentarily-starved accept loop
        for attempt in range(3):
            try:
                raw = await self._dial()
                break
            except (ConnectionError, OSError):
                if attempt == 2 or self._stop.is_set():
                    raise
                await asyncio.sleep(0.25 * (attempt + 1))
        log.info("connected to %s:%d", self.host, self.port)
        t = raw
        try:
            if self.encrypt:
                from asciichat_tpu_torch.net.crypto import CryptoContext
                from asciichat_tpu_torch.net.handshake import SecureChannel, client_handshake

                ctx = CryptoContext()
                if self.password:
                    # derive the Argon2id key ONCE per client: the salt is
                    # deterministic so the key never changes, and re-running
                    # the 64 MiB derivation on every reconnect attempt adds
                    # seconds of CPU to each retry on a small host
                    if self._password_key is None:
                        ctx.set_password(self.password)
                        self._password_key = ctx.password_key
                    else:
                        ctx.password_key = self._password_key
                known_hosts = None
                if self.ssh_identity is not None or self.gpg_identity is not None:
                    from asciichat_tpu_torch.net.knownhosts import KnownHosts

                    known_hosts = KnownHosts()
                if await client_handshake(raw, ctx, self.password,
                                          ssh_identity=self.ssh_identity,
                                          gpg_identity=self.gpg_identity,
                                          known_hosts=known_hosts,
                                          server_id=f"{self.host}:{self.port}"):
                    t = SecureChannel(raw, ctx, initiator=True)
                    log.info("encryption established (X25519 + XSalsa20-Poly1305)")
            await t.send(pkt.PacketType.PROTOCOL_VERSION, b"\x01")
            await t.send(pkt.PacketType.CLIENT_CAPABILITIES, self.wire_caps.pack())
            if self.source is not None:
                await t.send(pkt.PacketType.STREAM_START)
            # the handshake + caps exchange succeeded: this connection is
            # good, so the NEXT failure starts the backoff schedule fresh
            self.reconnect_policy.reset()
            # fresh dead-link clock for THIS session: carrying the previous
            # session's _last_rx across a reconnect let the keepalive
            # declare the new healthy link dead before the server's first
            # packet arrived (silence + backoff + handshake > threshold)
            self._last_rx = time.monotonic()
            tasks = [
                asyncio.create_task(self._capture_task(t)),
                asyncio.create_task(self._audio_capture_task(t)),
                asyncio.create_task(self._keepalive_task(t)),
            ]
            # live terminal resize -> SIZE_MESSAGE (SIGWINCH handling,
            # reference client sends updated dims on winch)
            import signal

            self._live_transport = t  # request_resize() during this session

            def on_winch():
                w, h = term.terminal_size(None, None)
                self.request_resize(w, h)

            loop = asyncio.get_running_loop()
            try:
                loop.add_signal_handler(signal.SIGWINCH, on_winch)
            except (ValueError, OSError, AttributeError):
                pass
            try:
                await self._recv_loop(t, max_frames)
            finally:
                self._live_transport = None
                try:
                    loop.remove_signal_handler(signal.SIGWINCH)
                except (ValueError, OSError, AttributeError):
                    pass
                for task in tasks:
                    task.cancel()
                for task in tasks:
                    # observe background failures: a capture/audio task that
                    # died mid-session must be LOGGED, not silently dropped
                    try:
                        await task
                    except asyncio.CancelledError:
                        pass
                    except Exception:
                        log.exception("background task failed mid-session")
                # best-effort farewell: an awaited send can block forever on
                # a full queue whose sender task already died
                t.send_nowait(pkt.PacketType.CLIENT_LEAVE)
        finally:
            await t.close()

    def _on_key(self, key: str) -> None:
        """Live client keybindings (keyboard_handler.c analog): quit, help
        overlay, fps overlay, horizontal flip of the uplink."""
        if key in ("q", "\x03"):
            # runs on the KeyboardReader THREAD: asyncio.Event.set() is not
            # thread-safe — marshal onto the loop. Setting the flag alone
            # never unblocked a recv parked on a HALF-OPEN link (and the
            # keepalive task exits on the flag before its dead-link close
            # could fire): also close the live transport so quit always
            # unwinds within the close bound instead of hanging forever.
            def _quit():
                self._stop.set()
                t = getattr(self, "_live_transport", None)
                if t is not None:
                    # ensure_future, not create_task: a DataChannel's close()
                    # closes at once and returns a plain awaitable, which
                    # create_task refuses (a TypeError in this callback)
                    task = asyncio.ensure_future(t.close())
                    self._quit_close_task = task  # strong ref

            if self._loop is not None:
                self._loop.call_soon_threadsafe(_quit)
            else:
                self._stop.set()
        elif key == "?":
            self.display.show_help = not self.display.show_help
        elif key == "s":
            self.display.show_fps = not self.display.show_fps
        elif key == "f":
            self.transform.flip_x = not self.transform.flip_x

    def request_resize(self, w: int, h: int) -> None:
        """Re-negotiate output dims mid-session (SIGWINCH path; also the
        programmatic surface soaks/tests use to exercise live resize —
        src/common/session/ SIZE_MESSAGE-on-winch role). No-op while
        disconnected; the next CLIENT_CAPABILITIES carries the new dims."""
        self.wire_caps.width, self.wire_caps.height = w, h
        self.display.set_meta(self.wire_caps.caps.renderer_key(),
                              (w, h))  # keep the fps overlay honest
        t = getattr(self, "_live_transport", None)
        if t is not None:
            t.send_nowait(pkt.PacketType.SIZE_MESSAGE, proto.pack_size(w, h))

    async def run(self, max_frames: int | None = None) -> None:
        from asciichat_tpu_torch.utils.keyboard import KeyboardReader

        # a failed handshake is terminal; only an encrypted session has one
        # (and only it may import the handshake, which needs cryptography)
        terminal: tuple = ()
        if self.encrypt:
            from asciichat_tpu_torch.net.handshake import HandshakeError

            terminal = (HandshakeError,)
        self._loop = asyncio.get_running_loop()
        keyboard = KeyboardReader(self._on_key)
        keyboard.start()
        self.display.setup()
        try:
            while not self._stop.is_set():
                try:
                    await self._session(max_frames)
                    if self._server_error is not None:
                        raise ServerError(*self._server_error)
                    self.reconnect_policy.reset()
                    if not self.reconnect_policy.enabled:
                        return
                except terminal:
                    # TERMINAL: wrong password / failed key auth / HOST KEY
                    # MISMATCH (possible MITM). Retrying would reduce an
                    # active MITM to an endlessly-repeated warning line and
                    # re-run the 64 MiB Argon2id derivation forever.
                    raise
                except (ConnectionError, asyncio.IncompleteReadError, OSError,
                        ValueError) as e:
                    if self._server_error is not None:
                        # the server closed right after its ERROR_MESSAGE:
                        # surface the REPORTED error, not the raw EOF
                        raise ServerError(*self._server_error) from e
                    if self._stop.is_set():
                        # the quit key closed the transport to unwind a
                        # parked recv: that is a CLEAN exit, not an error
                        return
                    # ValueError = corrupt packet (CRC/framing): treat like a
                    # broken connection — disconnect + reconnect, never crash
                    if not self.reconnect_policy.enabled:
                        raise
                    delay = self.reconnect_policy.next_delay()
                    log.warning("connection lost (%s); reconnecting in %.1fs", e, delay)
                    await asyncio.sleep(delay)
        finally:
            keyboard.stop()
            self.display.teardown()
            for dev in (self.audio_source, self.audio_sink, self.opus_enc,
                        self.opus_dec, self._h265_enc, self.source):
                if dev is not None:
                    try:
                        dev.close()
                    except Exception:
                        pass


def main(args) -> int:
    """``client`` mode over TCP, WebSocket (``--ws``) or WebRTC
    (``--webrtc``), or ``--browse``."""
    from asciichat_tpu_torch.render.types import RenderMode
    from asciichat_tpu_torch.runtime.framesource import open_source

    if args.address is None and not args.browse:
        print("client: an address is required (or use --browse)", flush=True)
        return 2
    if args.browse:
        # LAN server browser (lib/ui/mdns.c listing role)
        from asciichat_tpu_torch.net.mdns import discover

        found = discover(timeout=2.0)
        if not found:
            print("no ascii-chat servers announced on this LAN")
            return 1
        for svc in found:
            print(f"{svc.instance}  {svc.address}:{svc.port}  {svc.txt}")
        return 0

    caps = term.detect_capabilities(
        render_mode=RenderMode(args.render_mode),
        color_override=None if args.color_mode is None else args.color_mode,
    )
    w, h = term.terminal_size(args.width, args.height)
    wire = proto.WireCapabilities(caps=caps, width=w, height=h)
    if args.no_compress:
        wire.capabilities_mask |= 0x1  # cannot-decompress bit (webclient parity)
    source = None
    if not args.no_media:
        source = open_source(test_pattern=args.test_pattern, file=args.file,
                             loop=args.loop, stdin_size=args.stdin_size)
    audio_source = audio_sink = None
    want_uplink = args.audio or args.tone_hz is not None or args.audio_wav
    # a LISTEN-ONLY client (--audio-out or --opus without a capture source)
    # still needs the sink open: --audio-out used to be silently inert and
    # the received mix was discarded
    want_downlink = want_uplink or args.audio_out or args.opus
    if want_uplink or want_downlink:
        from asciichat_tpu_torch.runtime.audiodev import open_audio_sink, open_audio_source

        if want_uplink:
            audio_source = open_audio_source(
                tone_hz=args.tone_hz, wav=args.audio_wav,
                mic=args.audio and args.tone_hz is None and not args.audio_wav,
            )
        if want_downlink:
            audio_sink = open_audio_sink(args.audio_out)
    ssh_identity = None
    if args.ssh_key or args.ssh_agent:
        from asciichat_tpu_torch.net import sshauth

        ssh_identity = (sshauth.SshIdentity.from_private_key_file(args.ssh_key)
                        if args.ssh_key else sshauth.SshIdentity.from_agent())
        args.encrypt = True  # key auth requires the encrypted handshake
    gpg_identity = None
    if args.gpg_key:
        from asciichat_tpu_torch.net.gpgauth import GpgIdentity

        gpg_identity = GpgIdentity(args.gpg_key if args.gpg_key != "default"
                                   else None)
        args.encrypt = True
    client = AsciiChatClient(args.address, args.port, source, wire,
                             capture_fps=args.fps, reconnect=not args.no_reconnect,
                             encrypt=args.encrypt, password=args.password,
                             ssh_identity=ssh_identity,
                             gpg_identity=gpg_identity,
                             audio_source=audio_source,
                             audio_sink=audio_sink, want_h265=args.h265,
                             audio_gain=args.audio_gain, flip_x=args.flip_x,
                             flip_y=args.flip_y, show_fps=args.show_fps,
                             use_opus=args.opus, use_ws=args.ws,
                             use_webrtc=args.webrtc)
    try:
        asyncio.run(client.run(max_frames=args.max_frames))
    except KeyboardInterrupt:
        pass
    except Exception as e:
        if client.encrypt:
            from asciichat_tpu_torch.net.handshake import HandshakeError

            if isinstance(e, HandshakeError):
                # wrong password / TOFU host-key mismatch: the
                # SECURITY-relevant one-liner, not a buried traceback
                import sys as _sys

                print(f"error: {e}", file=_sys.stderr)
                return 1
        raise
    return 0
