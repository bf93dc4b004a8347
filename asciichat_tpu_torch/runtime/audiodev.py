"""Audio capture sources and playback sinks for the client.

Counterpart of the reference client's PortAudio capture/playback
(src/client/audio.c:276 audio_capture_thread, :531 audio_playback_thread) and
lib/audio/ device glue. This environment has no audio hardware or PortAudio;
the design mirrors runtime/framesource.py: a small Source/Sink interface with
real-device backends gated on availability (arecord/aplay CLIs) and
synthetic/file backends that exercise the identical pipeline.

All audio is 48 kHz mono float32 in [-1, 1] (audio.h:85-91), moved in
10 ms frames of 480 samples (AUDIO_FRAME_SAMPLES).
"""

from __future__ import annotations

import math
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

SAMPLE_RATE = 48_000
FRAME = 480  # 10 ms


class AudioSourceUnavailable(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Sources


class ToneSource:
    """Synthetic sine tone — the no-microphone capture source (the reference
    test suite uses synthetic buffers the same way, tests/unit/audio)."""

    def __init__(self, freq_hz: float = 440.0, amplitude: float = 0.2):
        self.freq = freq_hz
        self.amplitude = amplitude
        self._phase = 0.0

    def read(self, n: int = FRAME) -> np.ndarray:
        t = self._phase + np.arange(n, dtype=np.float64)
        out = (self.amplitude * np.sin(2 * math.pi * self.freq * t / SAMPLE_RATE))
        self._phase += n
        return out.astype(np.float32)

    def close(self) -> None:
        pass


class SilenceSource:
    """All-zero capture (a muted mic)."""

    def read(self, n: int = FRAME) -> np.ndarray:
        return np.zeros(n, np.float32)

    def close(self) -> None:
        pass


def _parse_float_wav(path: str) -> tuple[int, int, int, int, bytes]:
    """Minimal RIFF parse for WAV files the stdlib wave module refuses
    (IEEE float, unusual chunk order). -> (fmt_tag, rate, channels,
    sample_width, data); fmt_tag 1 = integer PCM, 3 = IEEE float."""
    import struct as _struct

    with open(path, "rb") as f:
        if f.read(4) != b"RIFF":
            raise ValueError("not a RIFF file")
        f.read(4)
        if f.read(4) != b"WAVE":
            raise ValueError("not a WAVE file")
        rate = ch = width = None
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], _struct.unpack("<I", hdr[4:])[0]
            body = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt, ch, rate, _br, _ba, bits = _struct.unpack("<HHIIHH", body[:16])
                if fmt not in (1, 3):  # PCM or IEEE float
                    raise ValueError(f"unsupported WAV format {fmt}")
                width = bits // 8
            elif cid == b"data":
                data = body
        if rate is None or data is None:
            raise ValueError("missing fmt/data chunks")
        return fmt, rate, ch, width, data


class WavFileSource:
    """Loops a WAV file as the capture source (PCM16/PCM32 via the stdlib
    wave module, IEEE-float32 via a direct RIFF parse; resampled to 48 kHz
    mono)."""

    def __init__(self, path: str, loop: bool = True):
        is_float = False
        try:
            with wave.open(path, "rb") as w:
                rate = w.getframerate()
                ch = w.getnchannels()
                width = w.getsampwidth()
                raw = w.readframes(w.getnframes())
        except wave.Error as e:
            # Python's wave module rejects IEEE-float WAVs (format 3, the
            # default for f32 exports); parse the RIFF chunks directly
            try:
                fmt_tag, rate, ch, width, raw = _parse_float_wav(path)
                is_float = fmt_tag == 3  # fmt 1 = integer PCM, decode as such
            except Exception:
                raise AudioSourceUnavailable(f"cannot read WAV {path!r}: {e}") from None
        except Exception as e:
            # wave.open raises more than wave.Error on malformed input
            # (EOFError on a truncated header, struct.error, ...) — every
            # unreadable file must surface the AudioSourceUnavailable
            # contract the factory and callers handle
            raise AudioSourceUnavailable(f"cannot read WAV {path!r}: {e}") from None
        try:
            if is_float and width == 4:
                data = np.frombuffer(raw, "<f4").astype(np.float32)
            elif width == 2:
                data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            elif width == 4:
                data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
            else:
                raise AudioSourceUnavailable(
                    f"unsupported WAV sample width {width}")
            if ch > 1:
                data = data.reshape(-1, ch).mean(axis=1)
        except ValueError as e:
            # a data chunk that is not a multiple of the sample size, or a
            # multichannel stream with a partial trailing frame
            raise AudioSourceUnavailable(f"corrupt WAV {path!r}: {e}") from None
        if not len(data):
            # BEFORE the resample: np.interp over an empty 44.1 kHz file
            # raised a raw numpy ValueError instead of the class contract
            raise AudioSourceUnavailable("empty WAV file")
        if rate != SAMPLE_RATE:
            out_len = int(len(data) * SAMPLE_RATE / rate)
            x = np.linspace(0.0, len(data) - 1, out_len)
            data = np.interp(x, np.arange(len(data)), data).astype(np.float32)
        self._data = data
        self._pos = 0
        self._loop = loop
        self.exhausted = False

    def read(self, n: int = FRAME) -> np.ndarray:
        out = np.zeros(n, np.float32)
        need, at = n, 0
        while need:
            if self._pos >= len(self._data):
                if not self._loop:
                    self.exhausted = True
                    break
                self._pos = 0
            take = min(need, len(self._data) - self._pos)
            out[at : at + take] = self._data[self._pos : self._pos + take]
            self._pos += take
            at += take
            need -= take
        return out

    def close(self) -> None:
        pass


class MicSource:
    """Real microphone via the ALSA `arecord` CLI (gated: no PortAudio or
    libasound binding ships in this environment; same CLI-pipe strategy as
    the ffmpeg frame source)."""

    def __init__(self, device: str = "default"):
        if shutil.which("arecord") is None:
            raise AudioSourceUnavailable("arecord not found (no ALSA CLI)")
        self.proc = subprocess.Popen(
            ["arecord", "-q", "-D", device, "-f", "FLOAT_LE",
             "-r", str(SAMPLE_RATE), "-c", "1", "-t", "raw"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        )

    def read(self, n: int = FRAME) -> np.ndarray:
        raw = self.proc.stdout.read(n * 4)
        if not raw:
            raise AudioSourceUnavailable("arecord stream ended")
        return np.frombuffer(raw.ljust(n * 4, b"\0"), "<f4").copy()

    def close(self) -> None:
        self.proc.terminate()
        _reap(self.proc)


def open_audio_source(tone_hz: float | None = None, wav: str | None = None,
                      mic: bool = False, amplitude: float = 0.2,
                      loop: bool = True):
    """Source factory mirroring framesource.open_source: explicit WAV/tone
    first, a real microphone when asked for, tone fallback otherwise.
    `loop=False` plays a WAV once; callers can watch `.exhausted` to stop
    muxing the zero-padded silence that follows."""
    if wav:
        return WavFileSource(wav, loop=loop)
    if tone_hz is not None:
        return ToneSource(tone_hz, amplitude) if tone_hz > 0 else SilenceSource()
    if mic:
        try:
            return MicSource()
        except AudioSourceUnavailable:
            pass  # no ALSA: fall through to the synthetic tone
    return ToneSource(440.0, amplitude)


# ---------------------------------------------------------------------------
# Sinks


class NullSink:
    """Counts + remembers level stats without a device (headless client)."""

    def __init__(self):
        self.samples = 0
        self.sumsq = 0.0

    def write(self, buf: np.ndarray) -> None:
        self.samples += len(buf)
        self.sumsq += float(np.dot(buf, buf))

    @property
    def rms(self) -> float:
        return math.sqrt(self.sumsq / self.samples) if self.samples else 0.0

    def close(self) -> None:
        pass


class FileSink(NullSink):
    """Raw float32 file sink — /dev/null-able playback capture for tests
    and for piping into external players."""

    def __init__(self, path: str):
        super().__init__()
        self._f = Path(path).open("wb")

    def write(self, buf: np.ndarray) -> None:
        super().write(buf)
        self._f.write(np.asarray(buf, "<f4").tobytes())

    def close(self) -> None:
        self._f.close()


class PlaybackSink(NullSink):
    """Real speaker via the ALSA `aplay` CLI (gated like MicSource)."""

    def __init__(self, device: str = "default"):
        super().__init__()
        if shutil.which("aplay") is None:
            raise AudioSourceUnavailable("aplay not found (no ALSA CLI)")
        # bufsize=0: the default 8 KiB BufferedWriter released live audio
        # to aplay in ~4-frame (40-50 ms) bursts — added latency/jitter and
        # start-of-stream underruns on a REAL-TIME path
        self.proc = subprocess.Popen(
            ["aplay", "-q", "-D", device, "-f", "FLOAT_LE",
             "-r", str(SAMPLE_RATE), "-c", "1", "-t", "raw"],
            stdin=subprocess.PIPE, stderr=subprocess.DEVNULL, bufsize=0,
        )

    def write(self, buf: np.ndarray) -> None:
        super().write(buf)
        if self.proc.stdin is None or self.proc.stdin.closed:
            return  # speaker already gone: degrade to the NullSink behavior
        try:
            self.proc.stdin.write(np.asarray(buf, "<f4").tobytes())
        except (BrokenPipeError, ValueError, OSError):
            # aplay died mid-session (device unplugged/busy): losing the
            # speaker must not crash the client's packet receive loop —
            # keep counting frames, stop writing
            try:
                self.proc.stdin.close()
            except Exception:
                pass

    def close(self) -> None:
        try:
            if self.proc.stdin and not self.proc.stdin.closed:
                self.proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass
        # aplay exits on stdin EOF after DRAINING its device buffer —
        # terminating immediately cut the final up-to-hundreds-of-ms of
        # every session's audio; escalate terminate->kill only on a hang
        # (an ALSA-ioctl-stuck child can ignore SIGTERM, and a raw
        # TimeoutExpired used to escape and crash the shutdown path)
        _reap(self.proc)


def _reap(proc) -> None:
    """EOF-drain, then terminate, then kill — never raises, never leaves
    a zombie (the codecs._close_pipe_codec discipline)."""
    try:
        proc.wait(timeout=5)
        return
    except Exception:
        pass
    proc.terminate()
    try:
        proc.wait(timeout=2)
    except Exception:
        proc.kill()
        try:
            proc.wait(timeout=5)
        except Exception:
            pass


def open_audio_sink(out: str | None = None):
    """Sink factory: explicit file path, real speaker when available,
    null sink otherwise."""
    if out:
        return FileSink(out)
    try:
        return PlaybackSink()
    except AudioSourceUnavailable:
        return NullSink()
