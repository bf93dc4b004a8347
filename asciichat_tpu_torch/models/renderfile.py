"""--render-file: offline render of the ASCII stream to a video file.

The port's counterpart of ``asciichat_tpu/models/renderfile.py``. The
reference rasters its terminal output through libvterm + FreeType into
pixels and encodes via libav (lib/media/render/renderer.c:28,
lib/media/ffmpeg_encoder.c). Here a GLYPH ATLAS (``glyph_atlas.npy`` beside
this module, written by ``tools/make_glyph_atlas.py`` from PIL's built-in
font) is loaded once, and per frame the cell records (``ops/cells``: K2, or
K1 for the half-block RGB modes, on the card) become pixels in plain PyTorch
on the records' device: each cell's glyph bitmap gathered from the atlas and
coloured with the cell's fg record, or the mode's block colours. Half-block
cells render their true top/bottom colors (the '▀' raster IS two color
blocks). Frames stream to Y4M (YCbCr 4:4:4, BT.601 full-range) or any
container via the native recorder, or the ffmpeg CLI when present.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import AsciiRenderer, plan_render
from asciichat_tpu_torch.render.types import TerminalCapabilities

ATLAS_PATH = Path(__file__).resolve().parent / "glyph_atlas.npy"


@functools.lru_cache(maxsize=1)
def glyph_atlas() -> tuple[np.ndarray, int, int]:
    """-> (atlas uint8 [96, gh, gw] ink coverage for ASCII 32..127, gh, gw).
    Loaded from the committed file: the font PIL offers differs between
    installations, so the atlas is fixed once, not rasterized here."""
    atlas = np.load(ATLAS_PATH, allow_pickle=False)
    if atlas.dtype != np.uint8 or atlas.ndim != 3 or atlas.shape[0] != 96:
        raise ValueError(f"{ATLAS_PATH}: expected uint8 [96, gh, gw], "
                         f"got {atlas.dtype} {list(atlas.shape)}")
    return atlas, atlas.shape[1], atlas.shape[2]


def raster_glyphs(fg: torch.Tensor, glyph_idx: torch.Tensor,
                  atlas: torch.Tensor) -> torch.Tensor:
    """fg uint8 [B,H,W,3] + glyph_idx int32 [B,H,W] (atlas rows) ->
    uint8 [B, H*gh, W*gw, 3]: each cell is its glyph's ink coverage times the
    cell color on black, the terminal-on-black appearance the reference's
    FreeType raster produces. int32 products: 255 x 255 wraps in uint8."""
    bitmaps = atlas[glyph_idx.long()]  # [B,H,W,gh,gw]
    px = (fg.to(torch.int32)[:, :, :, None, None, :]
          * bitmaps.to(torch.int32)[..., None]) // 255
    b, h, w, gh, gw, _ = px.shape
    return (px.permute(0, 1, 3, 2, 4, 5)
              .reshape(b, h * gh, w * gw, 3).to(torch.uint8))


@functools.lru_cache(maxsize=16)
def _glyph_index_tables(palette: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-palette host tables mapping records to atlas rows:
    luma_to_atlas[256] (truecolor: glyph by luminance) and
    key_to_atlas[64] (mono: glyph by palette run key)."""
    def to_atlas(entry: bytes) -> int:
        ch = entry[1] if entry[0] >= 1 else 0x20  # first byte of the glyph
        return (ch - 32) if 32 <= ch < 128 else 95  # non-ASCII -> block-ish DEL

    luma_tab = pal.luminance_glyph_table(palette)
    mono_tab = pal.mono_glyph_table(palette)
    luma_to_atlas = np.array([to_atlas(bytes(luma_tab[i])) for i in range(256)],
                             np.int32)
    key_to_atlas = np.array([to_atlas(bytes(mono_tab[i])) for i in range(64)],
                            np.int32)
    return luma_to_atlas, key_to_atlas


def _xterm256_rgb() -> np.ndarray:
    """[256, 3] uint8 xterm palette — unpacked from web/ansiparse.xterm256,
    the ONE copy of the cube/gray-ramp formula (a second local copy here
    could silently drift from the parser twin's)."""
    from asciichat_tpu_torch.web.ansiparse import xterm256

    packed = np.array([xterm256(n) for n in range(256)], np.uint32)
    return np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255],
                    axis=-1).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def _xterm256_device(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_xterm256_rgb()).to(device)


def cells_to_pixels(records: dict, mode: str, scale: int = 8,
                    key_max: int = 63) -> torch.Tensor:
    """Block-color fallback: cell records -> uint8 RGB frames. EVERY render
    mode maps here (the common non-truecolor terminals must be able to
    --render-file too): half-block rows are the glyph itself; quantized
    modes resolve their palette index to RGB; glyph modes approximate with
    ink coverage (glyph-accurate rasters live in records_to_pixels)."""
    if mode in ("halfblock_truecolor", "halfblock_mono"):
        px = torch.stack([records["top"], records["bot"]], dim=2)  # [B, R, 2, W, 3]
        b, r, _, w, _ = px.shape
        px = px.reshape(b, r * 2, w, 3)
    elif mode in ("halfblock_256", "halfblock_16"):
        table = _xterm256_device(records["fg"].device)
        top = table[records["fg"].long()]
        bot = table[records["bg"].long()]
        vis = (1 - records["transparent"])[..., None]
        px = torch.stack([top * vis, bot * vis], dim=2)
        b, r, _, w, _ = px.shape
        px = px.reshape(b, r * 2, w, 3)
    elif mode in ("truecolor_fg", "truecolor_fg_utf8",
                  "16color_dithered", "16color_dithered_bg"):
        rgb = records["rgb"].to(torch.int32)
        cov = records["luma"].to(torch.int32)[..., None]
        px = ((rgb * cov) // 255).to(torch.uint8)  # ink-coverage approx
    elif mode == "256color":
        table = _xterm256_device(records["color"].device)
        rgb = table[records["color"].long()].to(torch.int32)
        cov = records["luma"].to(torch.int32)[..., None]
        px = ((rgb * cov) // 255).to(torch.uint8)
    elif mode == "16color":
        table = _xterm256_device(records["color"].device)
        rgb = table[records["color"].long()].to(torch.int32)
        # key is a PALETTE char index (0..char_count-1, ops/pixel.mono_keys),
        # not a 0..63 luma bucket: //63 capped a pure-white pixel at 35%
        # brightness for the standard palette (key_max = char_count-1)
        cov = torch.clamp(records["key"].to(torch.int32) * 255 // key_max,
                          0, 255)[..., None]
        px = ((rgb * cov) // 255).to(torch.uint8)
    elif mode == "mono":
        key = records["key"].to(torch.int32)
        v = torch.clamp(key * 255 // key_max, 0, 255).to(torch.uint8)
        px = torch.stack([v, v, v], dim=-1)
    else:
        raise ValueError(f"render-file unsupported for mode {mode!r}")
    # nearest upscale so cells are visible blocks; half-block rows are
    # already 2 px per cell, so they take half the vertical repeat (never
    # 0: scale=1 must not produce a zero-height frame)
    vscale = max(1, scale // 2) if mode.startswith("halfblock") else scale
    return px.repeat_interleave(vscale, dim=-3).repeat_interleave(scale, dim=-2)


def records_to_pixels(records: dict, mode: str, palette: str,
                      scale: int = 8) -> torch.Tensor:
    """Glyph-accurate raster for glyph modes (atlas gather on the records'
    device); block colors for the others."""
    if mode in ("truecolor_fg", "mono"):
        first = next(iter(records.values()))
        atlas, luma_dev, key_dev = _glyph_device_tables(palette, first.device)
        if mode == "truecolor_fg":
            gidx = luma_dev[records["luma"].long()]
            fg = records["rgb"]
        else:
            gidx = key_dev[records["key"].long()]
            fg = torch.full((*records["key"].shape, 3), 204, dtype=torch.uint8,
                            device=first.device)  # grey text
        return raster_glyphs(fg, gidx, atlas)
    key_max = max(1, pal.get_palette_cache(palette).char_count - 1)
    return cells_to_pixels(records, mode, scale, key_max=key_max)


@functools.lru_cache(maxsize=16)
def _glyph_device_tables(palette: str, device: torch.device):
    """Atlas + index tables on ``device``, uploaded ONCE per palette and
    device: the render loop calls records_to_pixels per frame."""
    atlas_np, _gh, _gw = glyph_atlas()
    luma_to_atlas, key_to_atlas = _glyph_index_tables(palette)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (atlas_np, luma_to_atlas, key_to_atlas))


def rgb_to_ycbcr444(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 full-range integer RGB -> YCbCr (for Y4M C444). The shifts of
    negative int32 are arithmetic, as JAX's are."""
    px = rgb.to(torch.int32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = torch.clamp(128 + ((-43 * r - 85 * g + 128 * b + 128) >> 8), 0, 255)
    cr = torch.clamp(128 + ((128 * r - 107 * g - 21 * b + 128) >> 8), 0, 255)
    return torch.stack([y, cb, cr], dim=-1).to(torch.uint8)


class NativeRecorder:
    """Container recording on the system libavformat/libavcodec
    (lib/media/ffmpeg_encoder.c analog): RGB frames -> H.265 in any
    container the extension names (.mp4/.mkv/...)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 30,
                 crf: int = 28, audio_rate: int = 0):
        import ctypes

        from asciichat_tpu_torch.runtime import codecs

        self._lib = codecs._avshim()  # raises CodecUnavailable when absent
        c = ctypes
        self._ct = c
        if not hasattr(self._lib, "_rec_decl"):
            self._lib.ac_rec_open.restype = c.c_void_p
            self._lib.ac_rec_open.argtypes = [c.c_char_p] + [c.c_int] * 5
            self._lib.ac_rec_frame.restype = c.c_int
            self._lib.ac_rec_frame.argtypes = [c.c_void_p, c.c_char_p]
            self._lib.ac_rec_audio.restype = c.c_int
            self._lib.ac_rec_audio.argtypes = [c.c_void_p,
                                               c.POINTER(c.c_float), c.c_long]
            self._lib.ac_rec_close.restype = c.c_int
            self._lib.ac_rec_close.argtypes = [c.c_void_p]
            self._lib._rec_decl = True
        self._h = self._lib.ac_rec_open(path.encode(), width, height, fps,
                                        crf, audio_rate)
        if not self._h:
            raise codecs.CodecUnavailable(f"cannot open recorder for {path!r}")
        self.width, self.height = width, height

    def write_rgb(self, frame: np.ndarray) -> None:
        if frame.shape != (self.height, self.width, 3):
            # ac_rec_frame's sws_scale reads width*3 x height bytes
            # unconditionally: a smaller frame (source resolution changed
            # mid-stream) is a native heap over-read, not a Python error
            raise ValueError(
                f"frame {frame.shape} != opened {(self.height, self.width, 3)}")
        if self._lib.ac_rec_frame(
            self._h, np.ascontiguousarray(frame, np.uint8).tobytes()
        ) != 0:
            raise RuntimeError("recorder encode/mux failed")

    def write_audio(self, samples: np.ndarray) -> None:
        """Mono float samples onto the AAC track (ffmpeg_encoder.c audio
        mux role)."""
        buf = np.ascontiguousarray(samples, np.float32)
        if self._lib.ac_rec_audio(
            self._h, buf.ctypes.data_as(self._ct.POINTER(self._ct.c_float)),
            len(buf),
        ) != 0:
            raise RuntimeError("audio encode/mux failed")

    def close(self) -> None:
        if self._h:
            rc = self._lib.ac_rec_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError("recorder flush/trailer failed "
                                   "(container may be truncated)")


class Y4MWriter:
    """Minimal YUV4MPEG2 writer, C444 colorspace."""

    def __init__(self, path: str, width: int, height: int, fps: int = 30):
        self.width, self.height = width, height
        self.f = open(path, "wb")
        # XCOLORRANGE=FULL: rgb_to_ycbcr444 emits full-range BT.601; without
        # the tag every consumer (incl. our own ffmpeg transcode) assumes
        # limited range and crushes blacks / clips whites
        self.f.write(
            f"YUV4MPEG2 W{width} H{height} F{fps}:1 Ip A1:1 C444 "
            f"XCOLORRANGE=FULL\n".encode()
        )

    def write(self, ycbcr: np.ndarray) -> None:
        if ycbcr.shape != (self.height, self.width, 3):
            # raw planes under a fixed-size header: a resized later frame
            # silently desyncs every following frame in the stream
            raise ValueError(
                f"frame {ycbcr.shape} != opened {(self.height, self.width, 3)}")
        self.f.write(b"FRAME\n")
        # planar: all Y, all Cb, all Cr
        self.f.write(np.ascontiguousarray(ycbcr[..., 0]).tobytes())
        self.f.write(np.ascontiguousarray(ycbcr[..., 1]).tobytes())
        self.f.write(np.ascontiguousarray(ycbcr[..., 2]).tobytes())

    def close(self) -> None:
        self.f.close()


def render_to_file(
    source,
    out_path: str,
    caps: TerminalCapabilities,
    width: int,
    height: int,
    palette: str,
    max_frames: int = 300,
    fps: int = 30,
    scale: int = 8,
    audio_source=None,
    audio_rate: int = 48_000,
    *,
    device: torch.device | str | None = None,
) -> int:
    """Offline render loop: source frames -> cell records -> glyph-rastered
    pixel frames -> Y4M, or any container via the native libavformat
    recorder (.mp4/.mkv/...; ffmpeg-CLI transcode as the last fallback).
    ``device`` (default ``runtime.device.default_device()``) renders the
    records and pixels; only the finished frame comes to the host."""
    from asciichat_tpu_torch.runtime.codecs import CodecUnavailable

    renderer = AsciiRenderer(palette, device=device)
    use_native = not out_path.endswith(".y4m")
    recorder = None
    y4m_path = out_path if out_path.endswith(".y4m") else out_path + ".y4m"
    # H.265/mp4 encoders are yuv420p (avshim ac_rec_open): odd glyph-raster
    # dims (font-dependent cell size x caller scale) would fail the encode —
    # after every frame rendered. Pad to even ONCE, for every container path
    # (a .y4m deliverable keeps exact dims; C444 has no evenness rule).
    pad_even = not out_path.endswith(".y4m")

    writer = None
    rendered = 0
    fallback_audio: list[np.ndarray] = []
    try:
        for _ in range(max_frames):
            frame = source.read()
            if frame is None:
                break
            frame = np.asarray(frame)
            plan = plan_render(frame.shape[1], frame.shape[0], width, height, caps)
            records = renderer.cells_for_plan(renderer.to_device(frame[None]), plan)
            px = records_to_pixels(records, plan.mode, palette, scale)
            if pad_even and ((px.shape[1] | px.shape[2]) & 1):
                px = F.pad(px, (0, 0, 0, px.shape[2] & 1, 0, px.shape[1] & 1))
            if use_native and writer is None:
                if recorder is None:
                    try:
                        recorder = NativeRecorder(
                            out_path, px.shape[2], px.shape[1], fps,
                            audio_rate=audio_rate if audio_source else 0)
                    except CodecUnavailable:
                        use_native = False
                if recorder is not None:
                    recorder.write_rgb(px[0].cpu().numpy())
                    if audio_source is not None:
                        recorder.write_audio(audio_source.read(audio_rate // fps))
                    rendered += 1
                    continue
            ycbcr = rgb_to_ycbcr444(px)[0].cpu().numpy()
            if writer is None:
                writer = Y4MWriter(y4m_path, ycbcr.shape[1], ycbcr.shape[0], fps)
            writer.write(ycbcr)
            if audio_source is not None:
                # the fallback container has no audio mux; keep the samples
                # so the ffmpeg-CLI transcode can carry the requested track
                # instead of silently delivering a mute file
                fallback_audio.append(
                    np.asarray(audio_source.read(audio_rate // fps), np.float32))
            rendered += 1
    finally:
        # always flush + write trailers: a mid-render error must not leak
        # the native contexts or leave an unplayable container behind. A
        # close() failure must not MASK an in-flight render error (the root
        # cause) — it only propagates when nothing else is already raising.
        import sys as _sys

        in_flight = _sys.exc_info()[0] is not None
        for closer in (recorder, writer):
            if closer:
                try:
                    closer.close()
                except Exception:
                    if not in_flight:
                        raise
                    from asciichat_tpu_torch.utils.logsys import get_logger

                    get_logger("renderfile").warning(
                        "close failed while handling a render error",
                        exc_info=True)
    if writer and out_path != y4m_path:
        if shutil.which("ffmpeg"):
            cmd = ["ffmpeg", "-y", "-v", "error", "-i", y4m_path]
            wav_path = None
            if fallback_audio:
                wav_path = out_path + ".wav"
                _write_wav(wav_path, np.concatenate(fallback_audio), audio_rate)
                cmd += ["-i", wav_path, "-shortest"]
            subprocess.run(cmd + [out_path], check=True)
            os.remove(y4m_path)  # intermediate, not a deliverable
            if wav_path:
                os.remove(wav_path)
        else:
            # neither libavcodec nor the ffmpeg CLI can produce the asked-for
            # container: FAIL LOUDLY instead of reporting success while
            # out_path does not exist; the raw frames are preserved
            raise RuntimeError(
                f"no encoder available to produce {out_path!r}; raw frames "
                f"kept at {y4m_path!r} (install ffmpeg or libavcodec)")
    elif fallback_audio:
        from asciichat_tpu_torch.utils.logsys import get_logger

        get_logger("renderfile").warning(
            "Y4M carries no audio track: the requested audio was dropped "
            "(ask for .mp4/.mkv to keep it)")
    return rendered


def _write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Mono float32 [-1,1] -> 16-bit PCM WAV (the transcode side-channel)."""
    import wave

    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
