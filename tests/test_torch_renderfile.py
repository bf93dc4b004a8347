"""The port's ``--render-file`` (asciichat_tpu_torch/models/renderfile.py) on
the CPU, held to the JAX package's (asciichat_tpu/models/renderfile.py) with
the same inputs, made from a seed with numpy.

Exact equality throughout (the math is all integer): the committed glyph
atlas and ``glyph_atlas()``; the atlas index tables of every built-in palette
and the xterm table; ``raster_glyphs``, ``cells_to_pixels`` (every mode
string, scale 1, 2 and 8), ``records_to_pixels`` and ``rgb_to_ycbcr444``
(all 2^24 RGB triples); and the ``.y4m`` bytes of ``render_to_file`` in each
of the 10 record modes, at a geometry whose raster is even and one whose
raster is odd. The rest mirrors the JAX package's own render-file tests
(tests/test_subsystems.py:129,642,806, tests/test_review_r04.py:890-3185)
on the port: the even pad, the transcode that carries audio, no encoder
failing loudly, writers refusing a change of dimensions, 16-colour white at
full brightness, a close failure not masking the render error; and the
device rule: without a card and without ASCIICHAT_TORCH_DEVICE=cpu the
render raises."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asciichat_tpu.models import renderfile as jrf
from asciichat_tpu.ops import cells as jcells
from asciichat_tpu.render import palette as jpal
from asciichat_tpu.render import types as jtypes
from asciichat_tpu_torch.models import renderfile as trf
from asciichat_tpu_torch.ops import cells as tcells
from asciichat_tpu_torch.render import palette as tpal
from asciichat_tpu_torch.render import types as ttypes
from asciichat_tpu_torch.runtime import codecs as tcodecs
from asciichat_tpu_torch.runtime.device import DEVICE_ENV

CPU = torch.device("cpu")
STANDARD = tpal.DEFAULT_PALETTE
BLOCKS = tpal.BUILTIN_PALETTES["blocks"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _records(mode: str, seed: int, shape=(2, 16, 20), palette: str = STANDARD):
    """(JAX records, the same records as CPU tensors) of random frames."""
    b, h, w = shape
    frames = np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    ramp = jcells.ramp_for_palette(palette)
    jrecs = jcells.render_cells(jnp.asarray(frames), ramp, dst_h=h, dst_w=w, mode=mode)
    return jrecs, {k: _t(v) for k, v in jrecs.items()}


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# -- host tables ---------------------------------------------------------------

def test_committed_atlas_equals_glyph_atlas():
    pytest.importorskip("PIL", reason="the JAX package rasterizes its atlas with PIL")
    want, gh, gw = jrf.glyph_atlas()
    got, tgh, tgw = trf.glyph_atlas()
    assert (tgh, tgw) == (gh, gw) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(tpal.BUILTIN_PALETTES))
def test_glyph_index_tables_equal(name):
    palette = tpal.BUILTIN_PALETTES[name]
    assert palette == jpal.BUILTIN_PALETTES[name]
    for got, want in zip(trf._glyph_index_tables(palette), jrf._glyph_index_tables(palette)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_xterm_table_equal():
    np.testing.assert_array_equal(trf._xterm256_rgb(), jrf._xterm256_rgb())


def test_xterm256_rgb_matches_parser_twin():
    from asciichat_tpu_torch.ops.pixel import ANSI16_RGB

    t = trf._xterm256_rgb()
    np.testing.assert_array_equal(t[:16], np.asarray(ANSI16_RGB, np.uint8))
    assert tuple(t[16]) == (0, 0, 0) and tuple(t[231]) == (255, 255, 255)
    assert tuple(t[232]) == (8, 8, 8) and tuple(t[255]) == (238, 238, 238)


# -- device parts, bit for bit ---------------------------------------------------

def test_raster_glyphs_equal():
    rng = np.random.default_rng(3)
    atlas = rng.integers(0, 256, (96, 5, 4), dtype=np.uint8)
    fg = rng.integers(0, 256, (2, 3, 7, 3), dtype=np.uint8)
    idx = rng.integers(0, 96, (2, 3, 7), dtype=np.int32)
    want = jrf.raster_glyphs(jnp.asarray(fg), jnp.asarray(idx), jnp.asarray(atlas))
    _equal(trf.raster_glyphs(_t(fg), _t(idx), _t(atlas)), want)


@pytest.mark.parametrize("scale", [1, 2, 8])
@pytest.mark.parametrize("mode", [*tcells.MODES, "truecolor_fg_utf8"])
def test_cells_to_pixels_equal(mode, scale):
    jrecs, trecs = _records("truecolor_fg" if mode == "truecolor_fg_utf8" else mode,
                            seed=len(mode) + scale, shape=(2, 7, 9))
    key_max = tpal.get_palette_cache(STANDARD).char_count - 1
    want = jrf.cells_to_pixels(jrecs, mode, scale, key_max=key_max)
    _equal(trf.cells_to_pixels(trecs, mode, scale, key_max=key_max), want)


def test_cells_to_pixels_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unsupported"):
        trf.cells_to_pixels({}, "sixel")


@pytest.mark.parametrize("palette", [STANDARD, BLOCKS], ids=["standard", "blocks"])
@pytest.mark.parametrize("mode", tcells.MODES)
def test_records_to_pixels_equal(mode, palette):
    jrecs, trecs = _records(mode, seed=11, palette=palette)
    want = jrf.records_to_pixels(jrecs, mode, palette, scale=3)
    _equal(trf.records_to_pixels(trecs, mode, palette, scale=3), want)


def test_rgb_to_ycbcr444_all_triples():
    """Every one of the 2^24 RGB triples, in chunks of 2^22."""
    codes = np.arange(1 << 24, dtype=np.uint32)
    for lo in range(0, 1 << 24, 1 << 22):
        c = codes[lo:lo + (1 << 22)]
        rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
        want = np.asarray(jrf.rgb_to_ycbcr444(jnp.asarray(rgb)))
        got = trf.rgb_to_ycbcr444(torch.from_numpy(rgb)).numpy()
        np.testing.assert_array_equal(got, want)


# -- render_to_file: .y4m bytes ----------------------------------------------------

def _caps_for(mode: str, types):
    """Capabilities that dispatch to ``mode`` (``16color_dithered`` has no
    capabilities of its own: a subclass names it)."""
    if mode == "16color_dithered":
        @dataclasses.dataclass(frozen=True)
        class Dithered(types.TerminalCapabilities):
            def renderer_key(self) -> str:
                return "16color_dithered"

        return Dithered()
    for color in types.ColorLevel:
        for render in types.RenderMode:
            caps = types.TerminalCapabilities(color, render)
            if caps.renderer_key() == mode:
                return caps
    raise AssertionError(mode)


class _Frames:
    """A frame source that plays a fixed list once."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return self.frames.pop(0) if self.frames else None


def _y4m(package, types, mode, geometry, path, palette=STANDARD, **kw) -> bytes:
    frames = np.random.default_rng(17).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    width, height, scale = geometry
    n = package.render_to_file(_Frames(frames), str(path), _caps_for(mode, types),
                               width, height, palette, max_frames=5, scale=scale, **kw)
    assert n == 3
    return path.read_bytes()


@pytest.mark.parametrize("geometry", [(21, 7, 8), (15, 5, 3)], ids=["even", "odd"])
@pytest.mark.parametrize("mode", tcells.MODES)
def test_render_to_file_y4m_bytes_equal(mode, geometry, tmp_path):
    want = _y4m(jrf, jtypes, mode, geometry, tmp_path / "jax.y4m")
    got = _y4m(trf, ttypes, mode, geometry, tmp_path / "port.y4m", device=CPU)
    assert got.count(b"FRAME\n") == 3
    assert got == want


def test_render_to_file_blocks_palette_equal(tmp_path):
    """The ``blocks`` palette's UTF-8 glyphs map to atlas row 95."""
    assert (trf._glyph_index_tables(BLOCKS)[0] == 95).any()
    for mode in ("truecolor_fg", "mono"):
        want = _y4m(jrf, jtypes, mode, (21, 7, 8), tmp_path / "jax.y4m", BLOCKS)
        got = _y4m(trf, ttypes, mode, (21, 7, 8), tmp_path / "port.y4m", BLOCKS)
        assert got == want, mode


def test_render_to_file_needs_the_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    """No quiet render on the CPU: without ASCIICHAT_TORCH_DEVICE=cpu the
    default device is the card, and a machine without one raises."""
    monkeypatch.delenv(DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _y4m(trf, ttypes, "truecolor_fg", (21, 7, 8), tmp_path / "port.y4m")
    assert not (tmp_path / "port.y4m").exists()


# -- the JAX package's render-file tests, on the port ------------------------------

def test_render_file_y4m(tmp_path):
    from asciichat_tpu_torch.runtime.framesource import TestPatternSource

    out = tmp_path / "clip.y4m"
    caps = ttypes.TerminalCapabilities(ttypes.ColorLevel.TRUECOLOR, ttypes.RenderMode.HALF_BLOCK)
    n = trf.render_to_file(TestPatternSource(160, 120), str(out), caps,
                           width=40, height=12, palette="   .x", max_frames=5, scale=4)
    assert n == 5
    data = out.read_bytes()
    assert data.startswith(b"YUV4MPEG2 ")
    assert "C444" in data.split(b"\n", 1)[0].decode()
    assert data.count(b"FRAME\n") == 5


def test_renderfile_glyph_raster(tmp_path):
    """Dark cells are empty, bright cells carry the dense glyph's ink; the
    Y4M stream is well-formed."""
    from asciichat_tpu_torch.runtime.framesource import TestPatternSource

    atlas, gh, gw = trf.glyph_atlas()
    assert atlas.shape[0] == 96
    assert atlas[0].sum() == 0  # space has no ink
    assert atlas[ord("M") - 32].sum() > 0

    recs = {"rgb": torch.full((1, 2, 3, 3), 200, dtype=torch.uint8),
            "luma": torch.tensor([[[0, 128, 255]] * 2], dtype=torch.uint8)}
    px = trf.records_to_pixels(recs, "truecolor_fg", STANDARD).numpy()
    assert px.shape == (1, 2 * gh, 3 * gw, 3)
    assert px[0, :gh, :gw].sum() == 0  # luma 0 -> space -> black
    assert px[0, :gh, 2 * gw: 3 * gw].sum() > 0  # luma 255 -> dense glyph

    out = str(tmp_path / "clip.y4m")
    caps = ttypes.TerminalCapabilities(ttypes.ColorLevel.TRUECOLOR, ttypes.RenderMode.FOREGROUND)
    n = trf.render_to_file(TestPatternSource(64, 48), out, caps, 20, 8, STANDARD, max_frames=3)
    assert n == 3
    data = open(out, "rb").read()
    assert data.startswith(b"YUV4MPEG2 W" + str(20 * gw).encode())
    assert data.count(b"FRAME\n") == 3


def test_render_file_with_audio_mux(tmp_path):
    """With an audio source, the native recorder muxes an AAC track next to
    the H.265 video."""
    from asciichat_tpu_torch.runtime.audiodev import ToneSource
    from asciichat_tpu_torch.runtime.framesource import TestPatternSource

    try:
        tcodecs._avshim()
    except tcodecs.CodecUnavailable:
        pytest.skip("no libavcodec shim")
    out = str(tmp_path / "av.mp4")
    caps = ttypes.TerminalCapabilities(ttypes.ColorLevel.TRUECOLOR, ttypes.RenderMode.FOREGROUND)
    n = trf.render_to_file(TestPatternSource(64, 48), out, caps, 20, 8, STANDARD,
                           max_frames=10, fps=30, audio_source=ToneSource(440.0, 0.3))
    assert n == 10
    silent = str(tmp_path / "v.mp4")
    trf.render_to_file(TestPatternSource(64, 48), silent, caps, 20, 8, STANDARD,
                       max_frames=10, fps=30)
    assert (tmp_path / "av.mp4").stat().st_size > (tmp_path / "v.mp4").stat().st_size + 1000
    assert b"mp4a" in open(out, "rb").read()


def test_renderfile_all_modes_produce_pixels():
    """Every mode is render-file-able; half-block at scale=1 keeps at least
    one pixel row per cell row."""
    frames = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (1, 16, 20, 3), dtype=np.uint8))
    ramp = tcells.ramp_for_palette(STANDARD)
    for mode in tcells.MODES:
        recs = tcells.render_cells(frames, ramp, dst_h=16, dst_w=20, mode=mode)
        px = trf.records_to_pixels(recs, mode, STANDARD)
        assert px.ndim == 4 and px.shape[0] == 1 and px.shape[-1] == 3, mode
        assert px.shape[1] > 0 and px.shape[2] > 0, mode
        assert trf.cells_to_pixels(recs, mode, scale=1).shape[1] > 0, mode


def test_renderfile_no_encoder_fails_loudly(tmp_path, monkeypatch):
    """A container no encoder can produce raises; the raw frames stay."""
    from asciichat_tpu_torch.runtime.framesource import TestPatternSource

    class NoRec:
        def __init__(self, *a, **k):
            raise tcodecs.CodecUnavailable("nope")

    monkeypatch.setattr(trf, "NativeRecorder", NoRec)
    monkeypatch.setattr(trf.shutil, "which", lambda n: None)
    out = tmp_path / "clip.mp4"
    with pytest.raises(RuntimeError, match="no encoder"):
        trf.render_to_file(TestPatternSource(64, 48), str(out), ttypes.TerminalCapabilities(),
                           20, 8, "   ...',;:clodxkO0KXNWM", max_frames=2, fps=10)
    assert not out.exists()
    assert (tmp_path / "clip.mp4.y4m").exists()


def test_renderfile_16color_white_reaches_full_brightness():
    """The 16color/mono fallback scales the run key by the palette's
    char_count - 1, not 63: white reaches full brightness."""
    white = torch.full((1, 8, 10, 3), 255, dtype=torch.uint8)
    ramp = tcells.ramp_for_palette(STANDARD)
    recs = tcells.render_cells(white, ramp, dst_h=8, dst_w=10, mode="16color")
    assert trf.records_to_pixels(recs, "16color", STANDARD).max() >= 250
    recs_m = tcells.render_cells(white, ramp, dst_h=8, dst_w=10, mode="mono")
    n = tpal.get_palette_cache(STANDARD).char_count
    assert trf.cells_to_pixels(recs_m, "mono", key_max=n - 1).max() == 255


def test_renderfile_writers_reject_dimension_changes(tmp_path):
    y = trf.Y4MWriter(str(tmp_path / "a.y4m"), 10, 8)
    y.write(np.zeros((8, 10, 3), np.uint8))
    with pytest.raises(ValueError, match="opened"):
        y.write(np.zeros((6, 10, 3), np.uint8))
    y.close()
    try:
        rec = trf.NativeRecorder(str(tmp_path / "a.mp4"), 64, 64, 30)
    except tcodecs.CodecUnavailable:
        pytest.skip("no libavcodec")
    try:
        with pytest.raises(ValueError, match="opened"):
            rec.write_rgb(np.zeros((32, 64, 3), np.uint8))
        rec.write_rgb(np.zeros((64, 64, 3), np.uint8))
    finally:
        rec.close()


def test_y4m_header_declares_full_range(tmp_path):
    p = tmp_path / "r.y4m"
    trf.Y4MWriter(str(p), 4, 2).close()
    assert b"XCOLORRANGE=FULL" in p.read_bytes().split(b"\n", 1)[0]


def test_renderfile_pads_odd_dims_even(tmp_path, monkeypatch):
    """Containers other than .y4m pad an odd raster to even once, for the
    native and the transcode-intermediate paths."""
    opened = {}

    class FakeRecorder:
        def __init__(self, path, w, h, fps, crf=28, audio_rate=0):
            opened["dims"] = (w, h)
            raise tcodecs.CodecUnavailable("forced fallback")

    monkeypatch.setattr(trf, "NativeRecorder", FakeRecorder)
    monkeypatch.setattr(trf.shutil, "which", lambda *_: None)
    frames = _Frames([np.full((12, 16, 3), 200, np.uint8)] * 2)
    caps = ttypes.TerminalCapabilities(ttypes.ColorLevel.COLOR_16, ttypes.RenderMode.FOREGROUND)
    out = str(tmp_path / "v.mp4")
    # 15x5 cells at scale 3 -> 45x15 px, both odd
    with pytest.raises(RuntimeError, match="no encoder"):
        trf.render_to_file(frames, out, caps, 15, 5, " .:-=+*#%@", max_frames=2, scale=3)
    assert opened["dims"][0] % 2 == 0 and opened["dims"][1] % 2 == 0
    header = open(out + ".y4m", "rb").readline()
    fields = dict((f[:1], f[1:]) for f in header.split()[1:] if f[:1] in b"WH")
    assert int(fields[b"W"]) % 2 == 0 and int(fields[b"H"]) % 2 == 0


def test_renderfile_fallback_transcode_carries_audio(tmp_path, monkeypatch):
    """On the ffmpeg-CLI fallback the transcode muxes the collected samples
    and removes its intermediates."""
    class NoRecorder:
        def __init__(self, *a, **k):
            raise tcodecs.CodecUnavailable("forced fallback")

    calls = {}

    def fake_run(cmd, check):
        calls["cmd"] = cmd
        open(cmd[-1], "wb").write(b"mp4")

    class Tone:
        def read(self, n):
            return np.zeros(n, np.float32) + 0.25

    monkeypatch.setattr(trf, "NativeRecorder", NoRecorder)
    monkeypatch.setattr(trf.shutil, "which", lambda *_: "/usr/bin/ffmpeg")
    monkeypatch.setattr(trf.subprocess, "run", fake_run)
    frames = _Frames([np.full((12, 16, 3), 128, np.uint8)] * 3)
    caps = ttypes.TerminalCapabilities(ttypes.ColorLevel.TRUECOLOR, ttypes.RenderMode.FOREGROUND)
    out = str(tmp_path / "v.mp4")
    assert trf.render_to_file(frames, out, caps, 20, 6, " .:@", max_frames=3,
                              audio_source=Tone()) == 3
    cmd = calls["cmd"]
    assert "-shortest" in cmd and any(str(a).endswith(".wav") for a in cmd)
    assert not list(tmp_path.glob("*.wav")) and not list(tmp_path.glob("*.y4m"))


def test_renderfile_close_failure_does_not_mask_render_error(tmp_path, monkeypatch):
    monkeypatch.setattr(trf.Y4MWriter, "close",
                        lambda self: (_ for _ in ()).throw(RuntimeError("trailer")))

    class Src:
        n = 0

        def read(self):
            Src.n += 1
            if Src.n == 2:
                raise ValueError("boom mid-render")
            return np.full((12, 16, 3), 99, np.uint8)

    caps = ttypes.TerminalCapabilities(ttypes.ColorLevel.TRUECOLOR, ttypes.RenderMode.FOREGROUND)
    with pytest.raises(ValueError, match="boom mid-render"):
        trf.render_to_file(Src(), str(tmp_path / "v.y4m"), caps, 20, 6, " .:@", max_frames=5)
