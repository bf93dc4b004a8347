"""Media sources: TEST pattern / FILE / STDIN (media source abstraction,
include/ascii-chat/media/source.h:81-86, lib/media/source.c).

Webcam capture (V4L2/AVFoundation/MediaFoundation in the reference) needs
camera hardware; in this environment the synthetic test pattern
(lib/video/webcam/webcam.c:21-27, MEDIA_SOURCE_TEST) is the capture device,
exactly as the reference's own test suite uses it. FILE decode uses PIL for
images and the ffmpeg CLI for video when present (the reference links
libav*; this runtime shells out — gated on availability).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import numpy as np

from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("framesource")


class FrameSource:
    """Iterator of uint8 [H, W, 3] frames at a native size."""

    width: int
    height: int

    def read(self) -> np.ndarray | None:  # None = end of stream
        raise NotImplementedError

    def close(self) -> None:
        pass


class TestPatternSource(FrameSource):
    """Animated gradient + moving bars (synthetic webcam)."""

    def __init__(self, width: int = 640, height: int = 480, fps: float = 30.0):
        self.width = width
        self.height = height
        self.fps = fps
        self._t0 = time.monotonic()
        yy, xx = np.mgrid[0:height, 0:width]
        # R/G are static gradients and B is a phase-shifted COLUMN gradient
        # ((x+phase)%256, constant down each column) — so a frame is one
        # base copy + one broadcast row write instead of a full-frame modulo
        # + np.stack (3.2 ms -> ~0.3 ms per 480p read; at N soak clients
        # uplinking this was the single largest harness cost on a 1-core box)
        base = np.empty((height, width, 3), np.uint8)
        base[..., 0] = (xx * 255 // max(width - 1, 1)).astype(np.uint8)
        base[..., 1] = (yy * 255 // max(height - 1, 1)).astype(np.uint8)
        self._base = base
        # doubled row: phase<=255, x<width -> phase+x < width+256, so a
        # slice of this row IS ((x+phase)%256) for every phase
        self._brow = (np.arange(width + 256) % 256).astype(np.uint8)

    def read(self) -> np.ndarray:
        t = time.monotonic() - self._t0
        phase = int(t * 60) % 256
        frame = self._base.copy()
        frame[..., 2] = self._brow[phase : phase + self.width]
        # moving vertical bar for motion
        bar = int((t * self.width / 4) % self.width)
        frame[:, bar : min(bar + 8, self.width)] = (255, 255, 255)
        return frame


class ImageFileSource(FrameSource):
    """Still image via PIL, yielded repeatedly (like --file with an image)."""

    def __init__(self, path: str):
        from PIL import Image

        with Image.open(path) as img:  # close the fd; lazy PIL images hold it
            self._frame = np.asarray(img.convert("RGB"), dtype=np.uint8)
        self.height, self.width = self._frame.shape[:2]

    def read(self) -> np.ndarray:
        return self._frame


class NativeVideoFileSource(FrameSource):
    """Video decode on the system libavformat/libavcodec (native/avshim.cpp
    media path) — the primary --file video source, matching the reference's
    direct libav linkage (lib/media/ffmpeg_decoder.c). Any container
    libavformat demuxes; frames come back RGB24 at native size + fps."""

    _native_ctx = True  # close() frees a native context (no process to kill)

    def __init__(self, path: str, loop: bool = False):
        import ctypes

        from asciichat_tpu_torch.runtime import codecs

        try:
            self._lib = codecs._avshim()
        except codecs.CodecUnavailable as e:
            raise RuntimeError(str(e)) from None
        c = ctypes
        if not hasattr(self._lib, "_media_decl"):
            self._lib.ac_media_open.restype = c.c_void_p
            self._lib.ac_media_open.argtypes = [c.c_char_p]
            self._lib.ac_media_width.restype = c.c_int
            self._lib.ac_media_width.argtypes = [c.c_void_p]
            self._lib.ac_media_height.restype = c.c_int
            self._lib.ac_media_height.argtypes = [c.c_void_p]
            self._lib.ac_media_fps.restype = c.c_double
            self._lib.ac_media_fps.argtypes = [c.c_void_p]
            self._lib.ac_media_read_frame.restype = c.c_int
            self._lib.ac_media_read_frame.argtypes = [
                c.c_void_p, c.POINTER(c.c_uint8)]
            self._lib.ac_media_rewind.restype = c.c_int
            self._lib.ac_media_rewind.argtypes = [c.c_void_p]
            self._lib.ac_media_close.argtypes = [c.c_void_p]
            self._lib._media_decl = True
        self._path = path
        self._h = self._lib.ac_media_open(path.encode())
        if not self._h:
            raise RuntimeError(f"libavformat cannot open {path!r}")
        self.width = self._lib.ac_media_width(self._h)
        self.height = self._lib.ac_media_height(self._h)
        self.fps = self._lib.ac_media_fps(self._h) or 30.0
        self.loop = loop
        self._buf = np.empty(self.height * self.width * 3, np.uint8)
        self._c = c

    def read(self) -> np.ndarray | None:
        if not self._h:  # closed (or reopen failed): the C side has no guard
            return None
        ptr = self._buf.ctypes.data_as(self._c.POINTER(self._c.c_uint8))
        rc = self._lib.ac_media_read_frame(self._h, ptr)
        if rc == 0 and self.loop:
            # rewind via seek; raw streams without an index need a reopen
            if self._lib.ac_media_rewind(self._h) != 0:
                self._lib.ac_media_close(self._h)
                self._h = self._lib.ac_media_open(self._path.encode())
                if not self._h:
                    return None
            rc = self._lib.ac_media_read_frame(self._h, ptr)
        if rc <= 0:
            return None
        return self._buf.reshape(self.height, self.width, 3).copy()

    def close(self) -> None:
        if self._h:
            self._lib.ac_media_close(self._h)
            self._h = None


class FFmpegFileSource(FrameSource):
    """Video decode by piping rgb24 from the ffmpeg CLI (gated on PATH).
    Probes native fps so playback can be PTS-paced (PacedSource); wrap in
    PrefetchSource for the decode-ahead thread — open_source does both,
    matching the reference decoder's prefetch + pacing
    (lib/media/ffmpeg_decoder.c:276 prefetch thread, :316 PTS pacing)."""

    def __init__(self, path: str, loop: bool = False):
        if not shutil.which("ffmpeg") or not shutil.which("ffprobe"):
            raise RuntimeError("ffmpeg/ffprobe not available on PATH")
        probe_cmd = [
            "ffprobe", "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=width,height,r_frame_rate",
            "-of", "csv=p=0", path,
        ]
        probe = subprocess.run(probe_cmd, capture_output=True, text=True)
        if probe.returncode != 0:
            # surface ffprobe's actual diagnostic (check=True discarded the
            # captured stderr, leaving only a command + exit status)
            raise RuntimeError(
                f"ffprobe failed for {path!r}: "
                f"{probe.stderr.strip() or f'exit {probe.returncode}'}")
        fields = probe.stdout.strip().split(",")
        if len(fields) != 3 or not fields[0]:
            # audio-only / no-video-stream file: empty csv, which used to
            # detonate as a bare not-enough-values ValueError
            raise RuntimeError(f"no video stream in {path!r}")
        w, h, rate = fields
        self.width, self.height = int(w), int(h)
        num, _, den = rate.partition("/")
        # ffprobe reports "0/0" for single-image streams and some broken
        # containers: guard the denominator, fall back to 30
        den_f = float(den) if den else 1.0
        self.fps = (float(num) / den_f if den_f else 0.0) or 30.0
        cmd = ["ffmpeg", "-v", "error"]
        if loop:
            cmd += ["-stream_loop", "-1"]
        cmd += ["-i", path, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        self._frame_bytes = self.width * self.height * 3

    def read(self) -> np.ndarray | None:
        buf = self._proc.stdout.read(self._frame_bytes)
        if buf is None or len(buf) < self._frame_bytes:
            return None
        return np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)

    def close(self) -> None:
        # kill + reap: without wait() every closed source leaves a zombie
        # ffmpeg and an open pipe fd until the Popen object is GC'd
        self._proc.kill()
        try:
            self._proc.wait(timeout=5)
        except Exception:
            pass
        if self._proc.stdout is not None:
            self._proc.stdout.close()


class PrefetchSource(FrameSource):
    """Decode-ahead: a background thread keeps a bounded queue of decoded
    frames so read() never stalls on the decoder (the reference decoder's
    prefetch thread, ffmpeg_decoder.c:276)."""

    def __init__(self, inner: FrameSource, depth: int = 4):
        import queue
        import threading

        self.inner = inner
        self.width, self.height = inner.width, inner.height
        self.fps = getattr(inner, "fps", 30.0)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._eof = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        while not self._stop.is_set():
            try:
                frame = self.inner.read()
            except Exception:
                frame = None
            while not self._stop.is_set():
                try:
                    self._q.put(frame, timeout=0.2)
                    break
                except Exception:
                    continue
            if frame is None:
                self._eof = True  # EOF is sticky: later read()s return None
                return

    def read(self) -> np.ndarray | None:
        # never block once the producer is gone — a read() after EOF (e.g. a
        # reconnect starting a fresh capture task) must return None
        # immediately instead of wedging an executor thread forever
        if self._stop.is_set():
            return None
        import queue as _queue

        while True:
            # EOF with a drained queue: answer now — the sentinel was
            # already consumed and the 0.2 s blocking get charged every
            # post-EOF read (reconnect loops) 200 ms of dead executor wait
            if getattr(self, "_eof", False) and self._q.empty():
                return None
            try:
                return self._q.get(timeout=0.2)
            except _queue.Empty:
                if self._stop.is_set() or getattr(self, "_eof", False):
                    return None

    def close(self) -> None:
        self._stop.set()
        # unblock a blocked producer
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        # JOIN before closing the inner source: the producer may be inside
        # inner.read() right now, and closing a native source under it is a
        # use-after-free (ac_media_read_frame on a freed Media*). A producer
        # stuck in a blocking pipe read won't join — for PROCESS-backed
        # sources inner.close() kills the decoder process and unblocks it,
        # so fall through. A NATIVE source has no process to kill: freeing
        # the Media* under the stuck thread corrupts the heap — LEAK the
        # context instead (a stalled network stream read can block
        # indefinitely; one leaked decoder beats a corrupted process).
        self._thread.join(timeout=5.0)
        if self._thread.is_alive() and getattr(self.inner, "_native_ctx",
                                               False):
            log.warning("prefetch producer stuck in a native read; leaking "
                        "the decoder context instead of freeing it in use")
            return
        self.inner.close()


class PacedSource(FrameSource):
    """PTS pacing: frame i is released no earlier than t0 + i/fps, so file
    playback runs at the stream's native rate instead of decode speed
    (ffmpeg_decoder.c:316 pacing). Falling behind re-anchors rather than
    bursting (no catch-up flood)."""

    def __init__(self, inner: FrameSource, fps: float | None = None):
        self.inner = inner
        self.width, self.height = inner.width, inner.height
        self.fps = fps or getattr(inner, "fps", 30.0)
        self._t0: float | None = None
        self._idx = 0

    def read(self) -> np.ndarray | None:
        frame = self.inner.read()
        if frame is None:
            return None
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        due = self._t0 + self._idx / self.fps
        if due > now:
            time.sleep(due - now)
        elif now - due > 1.0 / self.fps * 4:
            # far behind (slow consumer): re-anchor the clock
            self._t0 = now - self._idx / self.fps
        self._idx += 1
        return frame

    def close(self) -> None:
        self.inner.close()


class StdinSource(FrameSource):
    """Raw rgb24 frames on stdin at a declared size (--stdin, memory AVIO
    analog of ffmpeg_decoder.c:160-207)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self._n = width * height * 3

    def read(self) -> np.ndarray | None:
        buf = sys.stdin.buffer.read(self._n)
        if len(buf) < self._n:
            return None
        return np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)


class WebcamSource(FrameSource):
    """Live camera via the V4L2 backend (runtime/webcam.py)."""

    def __init__(self, device: str = "/dev/video0", width: int = 640, height: int = 480):
        from asciichat_tpu_torch.runtime.webcam import open_webcam

        self._cam = open_webcam(device, width, height)
        self.width = self._cam.width
        self.height = self._cam.height
        self.fps = 30.0

    def read(self):
        # a select timeout inside the camera is TRANSIENT (auto-exposure
        # stall, USB hiccup) — returning None here would read as
        # end-of-stream to the capture loop and kill the uplink forever;
        # retry for a generous window before declaring the camera dead.
        # Backend exceptions (camera unplug -> WebcamUnavailable, spurious
        # V4L2 ioctl OSError) also mean dead: the capture loop has no
        # try/except, so they must become the documented return-None path.
        for _ in range(15):  # ~30 s at the 2 s device timeout
            try:
                frame = self._cam.read()
            except Exception:
                return None
            if frame is not None:
                return frame
        return None

    def close(self) -> None:
        self._cam.close()


def _gif_is_animated(path: str) -> bool:
    try:
        from PIL import Image

        with Image.open(path) as img:
            return getattr(img, "n_frames", 1) > 1
    except Exception:
        return False


def open_source(
    test_pattern: bool = False,
    file: str | None = None,
    stdin_size: tuple[int, int] | None = None,
    loop: bool = False,
    width: int = 640,
    height: int = 480,
    pace: bool = True,
) -> FrameSource:
    """pace=True (live playback) wraps video decode in prefetch + PTS pacing;
    pace=False (offline rendering, e.g. --render-file) decodes flat out."""

    def _video(path):
        try:
            src = NativeVideoFileSource(path, loop=loop)
        except RuntimeError:
            src = FFmpegFileSource(path, loop=loop)
        if pace:
            return PacedSource(PrefetchSource(src))
        return src

    if stdin_size:
        return StdinSource(*stdin_size)
    if file:
        lower = file.lower()
        if lower.startswith(("http://", "https://")):
            # yt-dlp URL resolution fallback (lib/media/yt_dlp.c): resolve the
            # page URL to a direct media URL, then decode via ffmpeg. Any
            # resolver failure — nonzero exit OR a hung site tripping the
            # timeout — falls through to direct ffmpeg decode of the URL.
            if shutil.which("yt-dlp"):
                try:
                    resolved = subprocess.run(
                        ["yt-dlp", "-g", "-f", "best", file],
                        capture_output=True, text=True, timeout=60,
                    )
                except subprocess.TimeoutExpired:
                    resolved = None
                if (resolved is not None and resolved.returncode == 0
                        and resolved.stdout.strip()):
                    file = resolved.stdout.strip().split("\n")[0]
            return _video(file)
        if lower.endswith(".gif") and _gif_is_animated(file):
            # animated GIFs decode through libav like the reference's --file
            # path (a PIL still would freeze on frame 0)
            return _video(file)
        if lower.endswith((".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")):
            return ImageFileSource(file)
        return _video(file)
    if not test_pattern:
        # default capture device: webcam when present, else the synthetic
        # pattern (MEDIA_SOURCE_TEST fallback, webcam.c:21-27)
        from asciichat_tpu_torch.runtime.webcam import WebcamUnavailable

        try:
            return WebcamSource(width=width, height=height)
        except WebcamUnavailable:
            pass
    return TestPatternSource(width, height)
