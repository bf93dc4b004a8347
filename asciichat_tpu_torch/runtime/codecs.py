"""Audio/video codecs on the system libraries — both REAL here.

Parity mapping:
- Opus (lib/audio/opus.c:19-143): ctypes straight on libopus.so (10 ms
  float frames at the audio-tick cadence, VOIP application, bitrate/DTX
  ctl). RawFloatAudioCodec remains the negotiated fallback (the reference
  also ships raw PCM AUDIO_BATCH as the non-Opus path).
- H.265 (lib/video/h265/{encoder,decoder}.c): the primary path is a native
  C++ shim on the system libavcodec/libswscale (native/avshim.cpp — the
  same linkage model the reference uses); the ffmpeg CLI pipe remains a
  fallback. Both paths expose the same AU-list interface; CodecUnavailable
  gates environments with neither.
"""

from __future__ import annotations

import shutil
import subprocess
import threading

import numpy as np

from asciichat_tpu_torch.utils.syncdebug import NamedLock

# NOTE: this framework runs Opus at the 10 ms AUDIO tick cadence (480
# samples, OpusCodec.frame_samples) — the reference batches 20 ms
# (src/server/render.c:57); a module constant advertising 960 here was
# dead AND wrong for every actual codec in this repo, so it was removed.


class CodecUnavailable(RuntimeError):
    pass


class RawFloatAudioCodec:
    """Identity codec: float32 PCM pass-through (AUDIO_BATCH wire format)."""

    name = "raw_float"

    def encode(self, samples: np.ndarray) -> bytes:
        return samples.astype("<f4").tobytes()

    def decode(self, data: bytes) -> np.ndarray:
        return np.frombuffer(data, "<f4")


def _load_libopus():
    import ctypes

    for name in ("libopus.so.0", "libopus.so", "libopus.0.dylib"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise CodecUnavailable("opus unavailable: no libopus on this system")
    c = ctypes
    lib.opus_encoder_create.restype = c.c_void_p
    lib.opus_encoder_create.argtypes = [c.c_int, c.c_int, c.c_int,
                                        c.POINTER(c.c_int)]
    lib.opus_decoder_create.restype = c.c_void_p
    lib.opus_decoder_create.argtypes = [c.c_int, c.c_int, c.POINTER(c.c_int)]
    lib.opus_encode_float.restype = c.c_int
    lib.opus_encode_float.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                      c.c_int, c.c_char_p, c.c_int]
    lib.opus_decode_float.restype = c.c_int
    lib.opus_decode_float.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                      c.POINTER(c.c_float), c.c_int, c.c_int]
    lib.opus_encoder_destroy.argtypes = [c.c_void_p]
    lib.opus_decoder_destroy.argtypes = [c.c_void_p]
    # variadic ctl: declare the FIXED parameters (ctx, request) so ctypes
    # uses the platform's variadic convention for the value argument — on
    # macOS arm64 the variadic args go on the stack, and with no argtypes
    # at all libopus would read register garbage for the bitrate/DTX value
    lib.opus_encoder_ctl.restype = c.c_int
    lib.opus_encoder_ctl.argtypes = [c.c_void_p, c.c_int]
    return lib


class OpusCodec:
    """Opus via ctypes straight on libopus (lib/audio/opus.c:19-143 analog:
    48 kHz mono float frames, VOIP application, bitrate + DTX ctl)."""

    name = "opus"
    APPLICATION_VOIP = 2048
    SET_BITRATE = 4002  # OPUS_SET_BITRATE_REQUEST
    SET_DTX = 4016  # OPUS_SET_DTX_REQUEST

    def __init__(self, bitrate: int = 32_000, dtx: bool = True,
                 frame_samples: int = 480):
        import ctypes

        self._c = ctypes
        self._lib = _load_libopus()
        self.frame_samples = frame_samples  # 10 ms (the AUDIO tick cadence)
        # Serializes encode/decode against close: the server's audio tick
        # runs encode/decode in an executor thread over a ClientState
        # snapshot while the event loop handles disconnects; close() must
        # never free the native context under a concurrent ctypes call.
        self._lock = threading.Lock()
        err = ctypes.c_int(0)
        self._enc = self._lib.opus_encoder_create(
            48000, 1, self.APPLICATION_VOIP, ctypes.byref(err))
        if err.value != 0 or not self._enc:
            raise CodecUnavailable(f"opus encoder create failed ({err.value})")
        self._dec = self._lib.opus_decoder_create(48000, 1, ctypes.byref(err))
        if err.value != 0 or not self._dec:
            raise CodecUnavailable(f"opus decoder create failed ({err.value})")
        for req, val in ((self.SET_BITRATE, bitrate),
                         (self.SET_DTX, 1 if dtx else 0)):
            rc = self._lib.opus_encoder_ctl(ctypes.c_void_p(self._enc),
                                            req, ctypes.c_int(val))
            if rc != 0:  # OPUS_OK: a failed ctl is degraded quality, not fatal
                from asciichat_tpu_torch.utils.logsys import get_logger

                get_logger("codecs").warning(
                    "opus_encoder_ctl(%d, %d) failed: %d", req, val, rc)

    def encode(self, samples: np.ndarray) -> bytes:
        pcm = np.ascontiguousarray(samples, np.float32)
        if pcm.shape != (self.frame_samples,):
            # shape, not len(): a (480, ch) stereo array passed the length
            # gate and opus consumed interleaved L/R as 480 mono samples —
            # corrupted audio with no error (same ctypes-boundary shape
            # discipline as NativeH265Encoder.encode)
            raise ValueError(
                f"opus frame must be shape ({self.frame_samples},), "
                f"got {pcm.shape}")
        out = self._c.create_string_buffer(4000)
        with self._lock:
            if not self._enc:
                raise ValueError("opus encoder is closed")
            n = self._lib.opus_encode_float(
                self._enc,
                pcm.ctypes.data_as(self._c.POINTER(self._c.c_float)),
                self.frame_samples, out, 4000)
        if n < 0:
            raise ValueError(f"opus_encode_float failed ({n})")
        return out.raw[:n]

    def decode(self, data: bytes) -> np.ndarray:
        pcm = np.empty(self.frame_samples, np.float32)
        with self._lock:
            if not self._dec:
                raise ValueError("opus decoder is closed")
            n = self._lib.opus_decode_float(
                self._dec, data, len(data),
                pcm.ctypes.data_as(self._c.POINTER(self._c.c_float)),
                self.frame_samples, 0)
        if n < 0:
            raise ValueError(f"opus_decode_float failed ({n})")
        return pcm[:n]

    def close(self) -> None:
        """Free the native contexts (~45 KB invisible to gc; the server
        churns one pair per opus client session). Safe against a concurrent
        encode/decode on another thread (the audio-tick executor)."""
        with self._lock:
            if self._enc:
                self._lib.opus_encoder_destroy(self._enc)
                self._enc = None
            if self._dec:
                self._lib.opus_decoder_destroy(self._dec)
                self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def best_audio_codec(prefer_opus: bool = True):
    if prefer_opus:
        try:
            return OpusCodec()
        except CodecUnavailable:
            pass
    return RawFloatAudioCodec()


def _split_access_units(buf: bytearray) -> list[bytes]:
    """Split an Annex-B HEVC byte stream on Access Unit Delimiter NALs
    (type 35; the encoder runs with aud=1 so every AU starts with one).
    Complete AUs are removed from `buf`; a partial tail stays."""
    positions = []
    i = 0
    while True:
        j = buf.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        nal_start = j + 3
        if nal_start >= len(buf):
            break
        nal_type = (buf[nal_start] >> 1) & 0x3F
        if nal_type == 35:  # AUD
            # include a preceding zero byte (4-byte start code form)
            start = j - 1 if j > 0 and buf[j - 1] == 0 else j
            positions.append(start)
        i = j + 3
    if len(positions) < 2:
        return []
    aus = [bytes(buf[positions[k] : positions[k + 1]])
           for k in range(len(positions) - 1)]
    del buf[: positions[-1]]
    return aus


import functools


_avshim_error: Exception | None = None


@functools.lru_cache(maxsize=1)
def _avshim_cached():
    """Native libavcodec shim (native/avshim.cpp): the primary H.265 path,
    matching the reference's direct libav* linkage
    (lib/video/h265/{encoder,decoder}.c)."""
    import ctypes

    from asciichat_tpu_torch.runtime.kernel_build import native_lib

    try:
        lib = native_lib("avshim")
    except Exception as e:  # compile or dlopen failure
        raise CodecUnavailable(f"libavcodec shim unavailable: {e}") from None
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.ac_h265_enc_open.restype = c.c_void_p
    lib.ac_h265_enc_open.argtypes = [c.c_int] * 5
    lib.ac_h265_enc_open_named.restype = c.c_void_p
    lib.ac_h265_enc_open_named.argtypes = [c.c_char_p] + [c.c_int] * 5
    lib.ac_h265_enc_frame.restype = c.c_long
    lib.ac_h265_enc_frame.argtypes = [c.c_void_p, c.c_char_p, u8p, c.c_long]
    lib.ac_h265_enc_drain.restype = c.c_long
    lib.ac_h265_enc_drain.argtypes = [c.c_void_p, u8p, c.c_long]
    lib.ac_h265_enc_close.argtypes = [c.c_void_p]
    lib.ac_h265_dec_open.restype = c.c_void_p
    lib.ac_h265_dec_open.argtypes = [c.c_int, c.c_int]
    lib.ac_h265_dec_packet.restype = c.c_long
    lib.ac_h265_dec_packet.argtypes = [c.c_void_p, c.c_char_p, c.c_long,
                                       u8p, c.c_long]
    lib.ac_h265_dec_close.argtypes = [c.c_void_p]
    return lib


def _avshim():
    """Compile-or-load the shim ONCE, caching failure too: lru_cache does
    not memoize exceptions, so an uncompilable shim used to re-run a
    multi-second g++ attempt on every codec construction — on the server
    that is the event-loop thread, per client dims-change (a remote stall
    lever). One attempt per process, then the cached outcome."""
    global _avshim_error
    if _avshim_error is not None:
        raise CodecUnavailable(str(_avshim_error))
    try:
        return _avshim_cached()
    except Exception as e:
        _avshim_error = e
        raise


class NativeH265Encoder:
    """H.265 encode on the system libavcodec via native/avshim.cpp —
    the encoder.c analog. One RGB24 frame in -> zero or more Annex-B
    packets out (low-latency x265: no reordering)."""

    name = "h265"

    def __init__(self, width: int, height: int, fps: int = 30, crf: int = 28,
                 keyint: int = 30, encoder: str | None = None):
        import ctypes

        self._c = ctypes
        self._lib = _avshim()
        self.width, self.height = width, height
        # hw-first ordered probe, cached (encoder.c:67-84 lazy-open analog)
        self.encoder_name = encoder if encoder is not None else probe_h265_encoder()
        if self.encoder_name is None:
            raise CodecUnavailable("no HEVC encoder opens (probe exhausted)")
        self._h = self._lib.ac_h265_enc_open_named(
            self.encoder_name.encode(), width, height, fps, crf, keyint)
        if not self._h:
            raise CodecUnavailable(
                f"HEVC encoder {self.encoder_name!r} failed to open")
        self._out = (ctypes.c_uint8 * (width * height * 3 + 65536))()
        self._lock = threading.Lock()

    def encode(self, frame: np.ndarray) -> list[bytes]:
        if frame.shape != (self.height, self.width, 3):
            # the native side reads height*width*3 bytes via sws_scale with
            # no length information — an undersized frame is a heap overread
            # (SIGSEGV, not a catchable exception), so gate the ctypes
            # boundary here where it IS catchable
            raise ValueError(
                f"frame shape {frame.shape} != "
                f"({self.height}, {self.width}, 3)")
        raw = np.ascontiguousarray(frame, np.uint8).tobytes()
        with self._lock:
            if self._h is None:
                raise ValueError("encoder closed")
            return self._encode_locked(raw)

    def _encode_locked(self, raw: bytes) -> list[bytes]:
        import struct

        n = self._lib.ac_h265_enc_frame(self._h, raw, self._out, len(self._out))
        # Overflow protocol: rv <= -2 means the first (-rv - 2) bytes are
        # valid records and a packet is still pending inside the shim (it is
        # never dropped — that would corrupt the stream until the next
        # keyframe). Grow the buffer and drain the remainder.
        chunks = []
        while n <= -2:
            # string_at = one memcpy; slicing a ctypes array first builds a
            # Python list of ints (megabytes of churn on the per-frame path)
            chunks.append(self._c.string_at(self._out, -n - 2))
            self._out = (self._c.c_uint8 * (len(self._out) * 2))()
            n = self._lib.ac_h265_enc_drain(self._h, self._out, len(self._out))
        if n < 0:
            raise ValueError("h265 encode failed")
        chunks.append(self._c.string_at(self._out, n))
        buf = b"".join(chunks)
        pkts, at = [], 0
        while at + 4 <= len(buf):
            (plen,) = struct.unpack("<I", buf[at : at + 4])
            pkts.append(buf[at + 4 : at + 4 + plen])
            at += 4 + plen
        return pkts

    def close(self) -> None:
        # same close-vs-use discipline as OpusCodec: freeing the native
        # context under a concurrent in-flight ctypes call (executor decode
        # racing the event loop's cleanup) is a use-after-free segfault
        with self._lock:
            if self._h:
                self._lib.ac_h265_enc_close(self._h)
                self._h = None


class NativeH265Decoder:
    """Per-client H.265 decode context on libavcodec
    (src/session/h265/server.c:14-25 analog)."""

    name = "h265"

    def __init__(self, width: int, height: int):
        import ctypes

        self._c = ctypes
        self._lib = _avshim()
        self.width, self.height = width, height
        self._h = self._lib.ac_h265_dec_open(width, height)
        if not self._h:
            raise CodecUnavailable("libavcodec has no HEVC decoder")
        self._frame_bytes = width * height * 3
        # Headroom for multi-frame yields (decoder flush bursts after
        # corruption recovery; a client bundling several AUs into one
        # payload). On overflow the shim leaves the surplus frames QUEUED in
        # the codec — they surface on the next call, but one received frame
        # is lost per overflow and SUSTAINED overflow backs avcodec up into
        # an EAGAIN decode failure — so keep the headroom generous, but cap
        # by BYTES: 32 frames at the server's 800x600 upload cap would pin
        # 44 MB per client (allocated on the event-loop thread).
        frames_cap = min(32, max(8, (16 << 20) // self._frame_bytes))
        self._out = (ctypes.c_uint8 * (self._frame_bytes * frames_cap))()
        self._lock = threading.Lock()

    def decode(self, au: bytes) -> list[np.ndarray]:
        with self._lock:
            if self._h is None:
                raise ValueError("decoder closed")
            n = self._lib.ac_h265_dec_packet(self._h, au, len(au), self._out,
                                             len(self._out))
            if n < 0:
                raise ValueError("h265 decode failed")
            fb = self._frame_bytes
            raw = self._c.string_at(self._out, n * fb)  # one memcpy
        return [
            np.frombuffer(raw, np.uint8, fb, i * fb).reshape(
                self.height, self.width, 3)
            for i in range(n)
        ]

    def close(self) -> None:
        # close-vs-use discipline (see OpusCodec): never free the native
        # context under an in-flight executor decode
        with self._lock:
            if self._h:
                self._lib.ac_h265_dec_close(self._h)
                self._h = None


class FFmpegH265Encoder:
    """Streaming H.265 encoder via the ffmpeg CLI (fallback when the
    libavcodec shim can't build; same AU interface).

    Low-latency x265 (tune zerolatency: no lookahead/reordering, one AU out
    per frame in) with aud=1 + repeat-headers=1 so each AU is self-framing
    and keyframe AUs are self-contained for mid-stream join."""

    name = "h265"

    def __init__(self, width: int, height: int, fps: int = 30, crf: int = 28,
                 keyint: int = 30):
        if not shutil.which("ffmpeg"):
            raise CodecUnavailable("h265 unavailable: no ffmpeg on PATH")
        self.width, self.height = width, height
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
             "-c:v", "libx265", "-preset", "ultrafast", "-tune", "zerolatency",
             "-x265-params", f"crf={crf}:keyint={keyint}:aud=1:repeat-headers=1",
             "-f", "hevc", "-"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        self._buf = bytearray()
        self._lock = NamedLock("codec.h265.encoder")
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        while True:
            chunk = self._proc.stdout.read(4096)
            if not chunk:
                return
            with self._lock:
                self._buf += chunk

    def encode(self, frame: np.ndarray) -> list[bytes]:
        """Feed one RGB24 frame; -> the complete encoded AUs available so far
        (zerolatency: normally one per call after the first)."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.shape != (self.height, self.width, 3):
            # rawvideo has NO framing: one wrong-sized frame desyncs every
            # subsequent frame boundary in the pipe, silently, forever —
            # the native encoder raises for this; the fallback must too
            raise ValueError(
                f"h265 frame must be {(self.height, self.width, 3)}, "
                f"got {frame.shape}")
        try:
            self._proc.stdin.write(frame.tobytes())
            self._proc.stdin.flush()
        except (ValueError, OSError) as e:
            # racing close() ("write to closed file") or a dead ffmpeg
            # (BrokenPipeError): surface the codec-failure contract, not an
            # unhandled exception in the caller's executor task
            raise ValueError(f"h265 encoder pipe closed: {e}") from None
        with self._lock:
            return _split_access_units(self._buf)

    def close(self) -> None:
        _close_pipe_codec(self._proc, self._reader)
        self._lock.unregister()


def _close_pipe_codec(proc, reader: threading.Thread) -> None:
    """Shut down an ffmpeg pipe codec WITHOUT leaking a zombie: kill()
    alone leaves the child un-reaped until the Popen object is GC'd (a
    long-lived server accumulates defunct processes), and the drain
    thread must be joined once stdout closes."""
    try:
        proc.stdin.close()
        proc.wait(timeout=5)
    except Exception:
        proc.kill()
        try:
            proc.wait(timeout=5)
        except Exception:
            pass
    reader.join(timeout=5)


class FFmpegH265Decoder:
    """Streaming H.265 decoder via the ffmpeg CLI (fallback path)."""

    name = "h265"

    def __init__(self, width: int, height: int):
        if not shutil.which("ffmpeg"):
            raise CodecUnavailable("h265 unavailable: no ffmpeg on PATH")
        self.width, self.height = width, height
        self._frame_bytes = width * height * 3
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-f", "hevc", "-i", "-",
             "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        self._buf = bytearray()
        self._lock = NamedLock("codec.h265.decoder")
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        while True:
            chunk = self._proc.stdout.read(self._frame_bytes)
            if not chunk:
                return
            with self._lock:
                self._buf += chunk

    def decode(self, au: bytes) -> list[np.ndarray]:
        """Feed one encoded AU; -> decoded RGB24 frames available so far."""
        try:
            self._proc.stdin.write(au)
            self._proc.stdin.flush()
        except (ValueError, OSError) as e:
            raise ValueError(f"h265 decoder pipe closed: {e}") from None
        frames = []
        with self._lock:
            while len(self._buf) >= self._frame_bytes:
                raw = bytes(self._buf[: self._frame_bytes])
                del self._buf[: self._frame_bytes]
                frames.append(
                    np.frombuffer(raw, np.uint8).reshape(self.height, self.width, 3)
                )
        return frames

    def close(self) -> None:
        _close_pipe_codec(self._proc, self._reader)
        self._lock.unregister()


# Hardware encoders first, software last — the implementations the reference
# probes by name (lib/video/h265/encoder.c:67-84), reordered hw-first per its
# lazy-open intent: a found-but-unopenable hw encoder falls through at the
# real avcodec_open2, so order costs nothing when hardware is absent.
H265_PROBE_ORDER = ("hevc_vaapi", "hevc_nvenc", "hevc_qsv",
                    "hevc_videotoolbox", "libx265")
_h265_probe_cache: dict[tuple, str | None] = {}
_h265_probe_lock = threading.Lock()


def probe_h265_encoder(order: tuple = H265_PROBE_ORDER,
                       try_open=None) -> str | None:
    """First HEVC encoder implementation that actually OPENS, else None.

    Each candidate is proven by a real open at a tiny size (the reference
    defers avcodec_open2 to first use, encoder.c:116-118; here the probe IS
    that open, cached so production pays it once). `try_open(name) -> bool`
    is injectable for fallback-logic tests."""
    if try_open is None:
        with _h265_probe_lock:
            if order in _h265_probe_cache:
                return _h265_probe_cache[order]

        def try_open(name: str) -> bool:
            try:
                lib = _avshim()
            except CodecUnavailable:
                return False
            h = lib.ac_h265_enc_open_named(name.encode(), 64, 64, 30, 28, 30)
            if not h:
                return False
            lib.ac_h265_enc_close(h)
            return True

        tried = []
        chosen = None
        for name in order:
            if try_open(name):
                chosen = name
                break
            tried.append(name)
        if chosen is None and shutil.which("ffmpeg"):
            # no buildable avshim but the ffmpeg CLI exists: H265Encoder()
            # WILL encode via FFmpegH265Encoder — reporting None here made
            # SERVER_STATE advertise h265 with 'h265_encoder: null' and log
            # 'negotiated: none' on a box that encodes fine
            chosen = "libx265/ffmpeg-cli"
        from asciichat_tpu_torch.utils.logsys import get_logger

        get_logger("codecs").info(
            "h265 encoder probe: %s%s",
            chosen or "NONE",
            f" (skipped: {', '.join(tried)})" if tried else "")
        with _h265_probe_lock:
            _h265_probe_cache[order] = chosen
        return chosen
    # injected try_open: pure fallback logic, uncached
    for name in order:
        if try_open(name):
            return name
    return None


def H265Encoder(width: int, height: int, fps: int = 30, crf: int = 28,
                keyint: int = 30):
    """Factory: native libavcodec shim first (the reference's own linkage
    model), ffmpeg CLI fallback; CodecUnavailable when neither exists."""
    try:
        return NativeH265Encoder(width, height, fps, crf, keyint)
    except CodecUnavailable:
        return FFmpegH265Encoder(width, height, fps, crf, keyint)


def H265Decoder(width: int, height: int):
    try:
        return NativeH265Decoder(width, height)
    except CodecUnavailable:
        return FFmpegH265Decoder(width, height)


@functools.lru_cache(maxsize=1)
def probe_video_codecs() -> list[str]:
    """VIDEO_CODEC_CAP_* capability probe for CLIENT_CAPABILITIES /
    SERVER_STATE codec negotiation. Cached: the first call may COMPILE the
    native shim (seconds) — callers on latency-sensitive paths should warm
    it via an executor (the server does at startup)."""
    codecs = ["raw_rgb24"]
    try:
        _avshim()
        codecs.append("h265")
    except CodecUnavailable:
        if shutil.which("ffmpeg"):
            codecs.append("h265")
    return codecs
