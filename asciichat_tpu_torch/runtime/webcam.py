"""V4L2 webcam capture (Linux) — pure-Python ioctl/mmap implementation.

Parity with lib/video/webcam/linux/webcam_v4l2.c: open /dev/videoN, negotiate
a pixel format (preferring RGB24, falling back to YUYV with software
conversion), mmap kernel buffers, stream on, and read frames by
dequeue/requeue. Gated on device availability: `open_webcam()` raises
WebcamUnavailable when no camera exists (this environment), and the media
source layer falls back to the synthetic test pattern exactly like the
reference's --test-pattern path (lib/video/webcam/webcam.c:21-27).

AVFoundation (macOS) and Media Foundation (Windows) backends are not
implemented — this runtime targets Linux hosts.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import select
import struct

import numpy as np

# V4L2 ioctl numbers (videodev2.h)
VIDIOC_QUERYCAP = 0x80685600
VIDIOC_S_FMT = 0xC0D05605
VIDIOC_REQBUFS = 0xC0145608
VIDIOC_QUERYBUF = 0xC0585609
VIDIOC_QBUF = 0xC058560F
VIDIOC_DQBUF = 0xC0585611
VIDIOC_STREAMON = 0x40045612
VIDIOC_STREAMOFF = 0x40045613

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1


def fourcc(a: str) -> int:
    return ord(a[0]) | ord(a[1]) << 8 | ord(a[2]) << 16 | ord(a[3]) << 24


V4L2_PIX_FMT_RGB24 = fourcc("RGB3")
V4L2_PIX_FMT_BGR24 = fourcc("BGR3")
V4L2_PIX_FMT_YUYV = fourcc("YUYV")
V4L2_PIX_FMT_NV12 = fourcc("NV12")
V4L2_PIX_FMT_MJPEG = fourcc("MJPG")


class WebcamUnavailable(RuntimeError):
    pass


def nv12_to_rgb(buf: bytes, width: int, height: int) -> np.ndarray:
    """NV12 (Y plane + interleaved half-res UV) -> RGB24, BT.601 integer math
    matching yuyv_to_rgb (webcam_v4l2.c NV12 path analog)."""
    n = width * height
    y = np.frombuffer(buf, np.uint8, n).reshape(height, width).astype(np.int32)
    uv = np.frombuffer(buf, np.uint8, n // 2, n).reshape(height // 2, width // 2, 2)
    u = np.repeat(np.repeat(uv[..., 0], 2, 0), 2, 1).astype(np.int32) - 128
    v = np.repeat(np.repeat(uv[..., 1], 2, 0), 2, 1).astype(np.int32) - 128
    c = y - 16
    r = np.clip((298 * c + 409 * v + 128) >> 8, 0, 255)
    g = np.clip((298 * c - 100 * u - 208 * v + 128) >> 8, 0, 255)
    b = np.clip((298 * c + 516 * u + 128) >> 8, 0, 255)
    return np.stack([r, g, b], -1).astype(np.uint8)


def mjpeg_to_rgb(buf: bytes) -> np.ndarray:
    """MJPEG frame -> RGB24 via PIL's JPEG decoder (the libjpeg role the
    reference fills natively)."""
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(bytes(buf))).convert("RGB"),
                      np.uint8)


def yuyv_to_rgb(buf: bytes, width: int, height: int) -> np.ndarray:
    """YUYV 4:2:2 -> RGB24, limited-range BT.601 integer math — the SAME
    298/409/516 coefficients as nv12_to_rgb (and what the reference's
    libswscale path produces for both formats, webcam_v4l2.c:758): the same
    scene must not change brightness depending on which format the V4L2
    device negotiated."""
    data = np.frombuffer(buf, np.uint8)[: width * height * 2].reshape(height, width // 2, 4)
    y0 = data[..., 0].astype(np.int32)
    u = data[..., 1].astype(np.int32) - 128
    y1 = data[..., 2].astype(np.int32)
    v = data[..., 3].astype(np.int32) - 128
    y = np.stack([y0, y1], axis=-1).reshape(height, width)
    u = np.repeat(u, 2, axis=-1)
    v = np.repeat(v, 2, axis=-1)
    c = y - 16
    r = (298 * c + 409 * v + 128) >> 8
    g = (298 * c - 100 * u - 208 * v + 128) >> 8
    b = (298 * c + 516 * u + 128) >> 8
    return np.stack([r, g, b], axis=-1).clip(0, 255).astype(np.uint8)


class V4L2Webcam:
    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, num_buffers: int = 4):
        if not os.path.exists(device):
            raise WebcamUnavailable(f"{device} does not exist")
        try:
            self.fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        except OSError as e:
            raise WebcamUnavailable(f"cannot open {device}: {e}") from e
        self.width = width
        self.height = height
        self.pixfmt = V4L2_PIX_FMT_RGB24
        self.stride = 0  # device bytesperline (set at format negotiation)
        self.buffers: list[mmap.mmap] = []
        try:
            self._setup(num_buffers)
        except OSError as e:
            os.close(self.fd)
            raise WebcamUnavailable(f"V4L2 setup failed: {e}") from e

    def _ioctl(self, req: int, arg) -> None:
        fcntl.ioctl(self.fd, req, arg)

    def _set_format(self, pixfmt: int) -> tuple[int, int, int]:
        # struct v4l2_format (64-bit layout, verified against the kernel
        # headers with a compiled offsetof probe): u32 type at 0, then the
        # fmt union 8-BYTE ALIGNED at offset 8 (it contains pointer-bearing
        # members), so v4l2_pix_format fields sit at width=8, height=12,
        # pixelformat=16, field=20
        fmt = bytearray(208)
        struct.pack_into("<L", fmt, 0, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<LLLL", fmt, 8, self.width, self.height, pixfmt, 1)
        self._ioctl(VIDIOC_S_FMT, fmt)
        w, h, got_fmt = struct.unpack_from("<LLL", fmt, 8)
        # bytesperline at pix_format offset 16 (fmt offset 24): devices that
        # pad rows for DMA alignment report a stride > width*bpp, and a
        # plain reshape would shear the image diagonally
        self.stride = struct.unpack_from("<L", fmt, 24)[0]
        return w, h, got_fmt

    def _setup(self, num_buffers: int) -> None:
        for pf in (V4L2_PIX_FMT_RGB24, V4L2_PIX_FMT_BGR24, V4L2_PIX_FMT_YUYV,
                   V4L2_PIX_FMT_NV12, V4L2_PIX_FMT_MJPEG):
            try:
                w, h, got = self._set_format(pf)
                if got == pf:
                    self.width, self.height, self.pixfmt = w, h, got
                    break
            except OSError:
                continue
        else:
            raise WebcamUnavailable(
                "no supported pixel format (RGB24/BGR24/YUYV/NV12/MJPEG)")

        req = bytearray(struct.pack("<LLL", num_buffers, V4L2_BUF_TYPE_VIDEO_CAPTURE,
                                    V4L2_MEMORY_MMAP).ljust(20, b"\0"))
        self._ioctl(VIDIOC_REQBUFS, req)
        count = struct.unpack_from("<L", req, 0)[0]
        for i in range(count):
            # struct v4l2_buffer 64-bit: index=0, type=4, bytesused=8,
            # memory=60, m.offset=64, length=72 (offsetof-probe verified)
            qb = bytearray(88)
            struct.pack_into("<L", qb, 0, i)  # index
            struct.pack_into("<L", qb, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_into("<L", qb, 60, V4L2_MEMORY_MMAP)
            self._ioctl(VIDIOC_QUERYBUF, qb)
            length = struct.unpack_from("<L", qb, 72)[0]
            offset = struct.unpack_from("<L", qb, 64)[0]
            self.buffers.append(
                mmap.mmap(self.fd, length, mmap.MAP_SHARED,
                          mmap.PROT_READ | mmap.PROT_WRITE, offset=offset)
            )
            self._ioctl(VIDIOC_QBUF, qb)
        self._ioctl(VIDIOC_STREAMON, struct.pack("<L", V4L2_BUF_TYPE_VIDEO_CAPTURE))

    def read(self, timeout: float = 2.0) -> np.ndarray | None:
        """One frame, or None when no frame arrived within `timeout` — that
        is a TRANSIENT condition (auto-exposure stall, USB hiccup), NOT
        end-of-stream; callers must retry, not treat it as EOF."""
        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            return None
        qb = bytearray(88)
        struct.pack_into("<L", qb, 4, V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("<L", qb, 60, V4L2_MEMORY_MMAP)
        self._ioctl(VIDIOC_DQBUF, qb)
        index = struct.unpack_from("<L", qb, 0)[0]
        used = struct.unpack_from("<L", qb, 8)[0]
        raw = self.buffers[index][: used or len(self.buffers[index])]
        if self.pixfmt == V4L2_PIX_FMT_YUYV:
            frame = yuyv_to_rgb(self._destride(raw, self.width * 2,
                                               self.height),
                                self.width, self.height)
        elif self.pixfmt == V4L2_PIX_FMT_NV12:
            if not self.stride or self.stride == self.width:
                # tightly packed (the common case): no copies
                frame = nv12_to_rgb(raw, self.width, self.height)
            else:
                # planar: de-stride the Y plane (stride x height) and the
                # interleaved UV plane (stride x height/2) independently
                y = self._destride(raw, self.width, self.height)
                uv_off = self.stride * self.height
                uv = self._destride(raw[uv_off:], self.width,
                                    self.height // 2)
                frame = nv12_to_rgb(y[: self.width * self.height] + uv,
                                    self.width, self.height)
        elif self.pixfmt == V4L2_PIX_FMT_MJPEG:
            frame = mjpeg_to_rgb(raw)
        else:
            tight = self._destride(raw, self.width * 3, self.height)
            frame = np.frombuffer(tight, np.uint8)[: self.width * self.height * 3]
            frame = frame.reshape(self.height, self.width, 3)
            if self.pixfmt == V4L2_PIX_FMT_BGR24:
                frame = frame[..., ::-1]
        self._ioctl(VIDIOC_QBUF, qb)
        return np.ascontiguousarray(frame)

    def _destride(self, raw: bytes, row_bytes: int, rows: int) -> bytes:
        """Drop per-row DMA padding (device-reported bytesperline) so the
        converters see tightly packed rows."""
        stride = self.stride
        if not stride or stride == row_bytes or len(raw) < stride * rows:
            return raw
        arr = np.frombuffer(raw, np.uint8, stride * rows).reshape(rows, stride)
        return arr[:, :row_bytes].tobytes()

    def close(self) -> None:
        try:
            self._ioctl(VIDIOC_STREAMOFF, struct.pack("<L", V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for b in self.buffers:
            b.close()
        os.close(self.fd)


class FfmpegDeviceWebcam:
    """Webcam via ffmpeg's device demuxers — the capture backend for
    macOS (`-f avfoundation`, webcam_avfoundation.m role) and Windows
    (`-f dshow`, webcam_mediafoundation.c role), where this framework has
    no native ioctl path. rgb24 frames stream over a pipe with the same
    read()/close()/width/height surface as V4L2Webcam.

    The input format/spec are injectable, which both selects the platform
    demuxer and makes the whole pipe path testable anywhere (`-f lavfi`
    with a testsrc graph, or a fake ffmpeg binary emitting rawvideo).

    NOTE: framesource.FFmpegFileSource reads the same rawvideo pipe
    contract but deliberately with BLOCKING buffered reads — a file decode
    either produces or ends. A live DEVICE can wedge while staying alive,
    so this class uses an unbuffered fd + select() stall timeout; the two
    are not merged because their stall contracts differ."""

    def __init__(self, informat: str, inspec: str, width: int = 640,
                 height: int = 480, fps: float = 30.0,
                 input_opts: tuple[str, ...] = (), binary: str = "ffmpeg"):
        import shutil as _sh
        import subprocess
        import tempfile

        if not _sh.which(binary):
            raise WebcamUnavailable(f"{binary} not on PATH (required for "
                                    f"{informat} capture)")
        self.width, self.height = width, height
        self._frame_bytes = width * height * 3
        cmd = [binary, "-v", "error", "-f", informat, *input_opts,
               "-i", inspec,
               "-vf", f"scale={width}:{height}", "-pix_fmt", "rgb24",
               "-f", "rawvideo", "pipe:1"]
        # stderr goes to a FILE, never a pipe: a flaky device can emit
        # error lines indefinitely, and an undrained 64 KB stderr pipe
        # blocks ffmpeg's writes — which blocks its stdout frames — which
        # deadlocks read() with no error surfaced.
        self._errfile = tempfile.TemporaryFile()
        # bufsize=0: read() uses select() on the raw fd for its stall
        # timeout; BufferedReader would hide readable bytes from select
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=self._errfile, bufsize=0)
        self._fps = fps
        self._pending = b""  # partial frame surviving a stall timeout

    def _stderr_tail(self) -> str:
        try:
            self._errfile.seek(0)
            return self._errfile.read()[-400:].decode(errors="replace")
        except Exception:
            return ""

    def read(self, timeout: float = 2.0):
        """One rgb24 frame as uint8 [H, W, 3]; None at end of stream OR
        on a `timeout`-second stall (same transient-stall contract as
        V4L2Webcam.read — WebcamSource's retry loop counts Nones and
        gives up after ~30 s instead of hanging a wedged device forever)."""
        import select as _select
        import time as _time

        # resume any partial frame from a previous stall: discarding the
        # consumed bytes would desynchronize the rawvideo stream permanently
        # (byte k of the old frame would become byte 0 of the next)
        buf = self._pending
        self._pending = b""
        fd = self._proc.stdout.fileno()
        deadline = _time.monotonic() + timeout
        while len(buf) < self._frame_bytes:
            left = deadline - _time.monotonic()
            if left <= 0:
                self._pending = buf  # keep alignment across the retry
                return None  # stalled device; caller retries / falls back
            r, _, _ = _select.select([fd], [], [], left)
            if not r:
                continue
            chunk = os.read(fd, self._frame_bytes - len(buf))
            if not chunk:  # EOF: ffmpeg exited
                err = self._stderr_tail()
                if err.strip():
                    raise WebcamUnavailable(f"device capture failed: {err}")
                return None
            buf += chunk
        return np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)

    def close(self) -> None:
        try:
            self._proc.terminate()
            self._proc.wait(timeout=2)
        except Exception:
            try:
                self._proc.kill()
            except Exception:
                pass
        try:
            self._errfile.close()
        except Exception:
            pass


def parse_dshow_devices(stderr_text: str) -> list[str]:
    """Video device names from `ffmpeg -list_devices true -f dshow -i
    dummy` stderr. Pure (unit-tested); the listing format is ffmpeg's
    documented one: quoted name lines followed by 'Alternative name'
    lines, with '(video)' / '(audio)' markers on modern builds."""
    names: list[str] = []
    in_video = True  # legacy builds print a 'DirectShow video devices' header
    for line in stderr_text.splitlines():
        low = line.lower()
        if "directshow video devices" in low:
            in_video = True
            continue
        if "directshow audio devices" in low:
            in_video = False
            continue
        if "alternative name" in low:
            continue
        start = line.find('"')
        end = line.rfind('"')
        if start < 0 or end <= start:
            continue
        name = line[start + 1 : end]
        if "(video)" in low or ("(" not in low.split('"')[-1] and in_video):
            names.append(name)
    return names


def list_dshow_devices(binary: str = "ffmpeg") -> list[str]:  # pragma: no cover
    """Enumerate DirectShow video devices (Windows)."""
    import subprocess

    try:
        r = subprocess.run([binary, "-hide_banner", "-list_devices", "true",
                            "-f", "dshow", "-i", "dummy"],
                           capture_output=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return parse_dshow_devices(r.stderr.decode(errors="replace"))


def open_webcam(device: str = "/dev/video0", width: int = 640, height: int = 480):
    """Platform capture dispatch (lib/video/webcam/webcam.c:20-46 role):
    Linux -> native V4L2 ioctl/mmap; macOS -> ffmpeg avfoundation; Windows
    -> ffmpeg dshow. Raises WebcamUnavailable when no backend can open
    (callers fall back to the test pattern, webcam.c:21-27)."""
    import sys as _sys

    if _sys.platform.startswith("linux"):
        return V4L2Webcam(device, width, height)
    if _sys.platform == "darwin":  # pragma: no cover - needs macOS
        # avfoundation device spec: index or name; map the Linux-default
        # /dev/video0 convention to camera 0
        spec = "0" if device.startswith("/dev/") else (device or "0")
        return FfmpegDeviceWebcam(
            "avfoundation", spec, width, height,
            input_opts=("-framerate", "30", "-pixel_format", "uyvy422"))
    if _sys.platform == "win32":  # pragma: no cover - needs Windows
        if device.startswith("/dev/") or not device:
            cams = list_dshow_devices()
            if not cams:
                raise WebcamUnavailable("no DirectShow video devices found")
            device = cams[0]
        return FfmpegDeviceWebcam("dshow", f"video={device}", width, height)
    raise WebcamUnavailable(f"no webcam backend for {_sys.platform}")
