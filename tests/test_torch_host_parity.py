"""The port's copies of the JAX package's host modules produce what the
originals produce, byte for byte, on the same inputs: the emitter (both
bind ``native/emitter.cpp``, built into their own directories), the oracle
(the reference's scalar renderer, the port's byte judge), ACIP framing and
CRC32-C, the command line's parser (namespaces and help), the resize index
tables, and the client's audio sources and sinks (tone, WAV files in PCM16
and float, file sink)."""

import struct
import wave

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from asciichat_tpu.apps import main as jmain
from asciichat_tpu.net import packet as jpkt
from asciichat_tpu.render import emitter as jemitter
from asciichat_tpu.render import oracle as joracle
from asciichat_tpu.render import palette as jpal
from asciichat_tpu.render import types as jtypes
from asciichat_tpu.runtime import audiodev as jaudiodev
from asciichat_tpu.utils import aspect as jaspect
from asciichat_tpu_torch.apps import main as tmain
from asciichat_tpu_torch.net import packet as tpkt
from asciichat_tpu_torch.ops import cells as tcells
from asciichat_tpu_torch.render import emitter as temitter
from asciichat_tpu_torch.render import oracle as toracle
from asciichat_tpu_torch.render import palette as tpal
from asciichat_tpu_torch.render import types as ttypes
from asciichat_tpu_torch.runtime import audiodev as taudiodev
from asciichat_tpu_torch.utils import aspect as taspect

from conftest import synthetic_frame

MODES = list(tcells.MODES)


# -- emitter -----------------------------------------------------------------

EMIT_CASES = [  # (batch, rows, cols), palette, (pad_w, pad_h)
    ((3, 18, 31), "standard", (0, 0)),
    ((2, 7, 5), "blocks", (3, 2)),
    ((1, 13, 40), "cool", (1, 0)),
    ((2, 1, 1), "digital", (0, 5)),
]


def _records(frames: np.ndarray, mode: str, palette: str) -> dict[str, np.ndarray]:
    """The mode's cell records of ``frames`` at their own size (the port's
    plain path), so every record holds a value its mode can emit."""
    recs = tcells.render_cells(torch.from_numpy(frames), tcells.ramp_for_palette(palette),
                               dst_h=frames.shape[1], dst_w=frames.shape[2], mode=mode)
    return tcells.records_to_numpy(recs)


@pytest.mark.parametrize("shape,palette_name,pad", EMIT_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_emitter_bytes_match(mode, shape, palette_name, pad):
    rng = np.random.default_rng(len(mode) * 100 + shape[1])
    frames = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    frames[0, : shape[1] // 2] = 0  # black runs (half-block transparency)
    if shape[2] > 4:
        frames[-1, :, 2:] = frames[-1, :, 1:2]  # long runs (REP escapes)
    palette = jpal.BUILTIN_PALETTES[palette_name]
    assert tpal.BUILTIN_PALETTES[palette_name] == palette
    recs = _records(frames, mode, palette)
    pad_w, pad_h = pad
    want = jemitter.emit_frames(recs, mode, palette, pad_w=pad_w, pad_h=pad_h)
    for nthreads in (1, 3):
        got = temitter.emit_frames(recs, mode, palette, pad_w=pad_w, pad_h=pad_h,
                                   nthreads=nthreads)
        assert got == want, f"{mode} {shape} {palette_name} pad {pad}, {nthreads} threads"


# -- oracle ------------------------------------------------------------------

def _mode_fn(oracle, mode):
    """The oracle's renderer of ``mode`` (tests/test_golden_render.py)."""
    return {
        "mono": lambda rgb, p: oracle.render_mono(rgb, p),
        "truecolor_fg": lambda rgb, p: oracle.render_truecolor_fg(rgb, p),
        "256color": lambda rgb, p: oracle.render_256color(rgb, p),
        "16color": lambda rgb, p: oracle.render_16color(rgb, p),
        "16color_dithered": lambda rgb, p: oracle.render_16color_dithered(rgb, p),
        "16color_dithered_bg": lambda rgb, p: oracle.render_16color_dithered_bg(rgb, True, p),
        "halfblock_truecolor": lambda rgb, p: oracle.render_halfblock_truecolor(rgb),
        "halfblock_256": lambda rgb, p: oracle.render_halfblock_256(rgb, p),
        "halfblock_16": lambda rgb, p: oracle.render_halfblock_16(rgb, p),
        "halfblock_mono": lambda rgb, p: oracle.render_halfblock_mono(rgb, p),
    }[mode]


def _golden_frames() -> list[np.ndarray]:
    """The frames of tests/test_golden_render.py's per-mode tests."""
    frames = list(np.random.default_rng(7).integers(0, 256, (3, 18, 31, 3), dtype=np.uint8))
    runs = synthetic_frame(13, 40, seed=3)
    runs[:, 5:25] = runs[:, 5:6]
    runs[4:9, :] = 0
    runs[0, :] = 255
    return frames + [runs]


@pytest.mark.parametrize("mode", MODES)
def test_oracle_mode_bytes_match(mode):
    for i, frame in enumerate(_golden_frames()):
        want = _mode_fn(joracle, mode)(frame, jpal.DEFAULT_PALETTE)
        assert _mode_fn(toracle, mode)(frame, tpal.DEFAULT_PALETTE) == want, f"frame {i}"


@pytest.mark.parametrize("palette_name", ["standard", "blocks", "minimal", "cool"])
def test_oracle_utf8_palettes_match(palette_name):
    frame = synthetic_frame(10, 24, seed=9)
    palette = jpal.BUILTIN_PALETTES[palette_name]
    for mode in ("mono", "truecolor_fg", "256color", "16color"):
        assert (_mode_fn(toracle, mode)(frame, palette)
                == _mode_fn(joracle, mode)(frame, palette)), mode


CAPS = [(jtypes.ColorLevel.TRUECOLOR, jtypes.RenderMode.FOREGROUND),
        (jtypes.ColorLevel.TRUECOLOR, jtypes.RenderMode.BACKGROUND),
        (jtypes.ColorLevel.TRUECOLOR, jtypes.RenderMode.HALF_BLOCK),
        (jtypes.ColorLevel.COLOR_256, jtypes.RenderMode.FOREGROUND),
        (jtypes.ColorLevel.COLOR_256, jtypes.RenderMode.HALF_BLOCK),
        (jtypes.ColorLevel.COLOR_16, jtypes.RenderMode.FOREGROUND),
        (jtypes.ColorLevel.NONE, jtypes.RenderMode.FOREGROUND),
        (jtypes.ColorLevel.NONE, jtypes.RenderMode.HALF_BLOCK)]


@pytest.mark.parametrize("level,render_mode", CAPS)
def test_oracle_full_convert_matches(level, render_mode):
    """Aspect fit, resize, render and padding, with and without padding and
    stretch (tests/test_golden_render.py's full-convert frames)."""
    frame, small = synthetic_frame(48, 64, seed=11), synthetic_frame(30, 40, seed=2)
    for padding in (True, False):
        jcaps = jtypes.TerminalCapabilities(level, render_mode, wants_padding=padding)
        tcaps = ttypes.TerminalCapabilities(ttypes.ColorLevel(int(level)),
                                            ttypes.RenderMode(int(render_mode)),
                                            wants_padding=padding)
        assert tcaps.renderer_key() == jcaps.renderer_key()
        for img, w, h, stretch in ((frame, 46, 14, False), (small, 50, 20, False),
                                   (small, 50, 20, True)):
            want = joracle.ascii_convert_with_capabilities(img, w, h, jcaps, stretch=stretch)
            got = toracle.ascii_convert_with_capabilities(img, w, h, tcaps, stretch=stretch)
            assert got == want, (img.shape, w, h, padding, stretch)


# -- ACIP framing and CRC32-C -------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(payload=st.binary(max_size=4096), ptype=st.integers(0, 0xFFFF),
       client_id=st.integers(0, 0xFFFFFFFF))
def test_packet_framing_and_crc_match(payload, ptype, client_id):
    assert tpkt.crc32c(payload) == jpkt.crc32c(payload) == jpkt._crc32c_py(payload)
    framed = tpkt.pack_packet(ptype, payload, client_id)
    assert framed == jpkt.pack_packet(ptype, payload, client_id)
    assert tpkt.unpack_header(framed[:tpkt.HEADER_SIZE]) == \
        jpkt.unpack_header(framed[:jpkt.HEADER_SIZE])
    assert tpkt.verify_payload(payload, tpkt.crc32c(payload))


@settings(max_examples=50, deadline=None)
@given(body=st.binary(min_size=1, max_size=2048), w=st.integers(1, 400),
       h=st.integers(1, 200))
def test_frame_payloads_match(body, w, h):
    got, want = tpkt.pack_image_frame(body, w, h), jpkt.pack_image_frame(body, w, h)
    ts = slice(20, 24)  # the header's last field: the clock in milliseconds
    assert got[:ts.start] + got[ts.stop:] == want[:ts.start] + want[ts.stop:]
    assert tpkt.unpack_image_frame(got) == jpkt.unpack_image_frame(got)
    assert tpkt.pack_audio_batch(body, len(body) // 4, 1) == \
        jpkt.pack_audio_batch(body, len(body) // 4, 1)
    for compress in (False, True):
        framed = tpkt.pack_ascii_frame(body, w, h, compress=compress)
        assert framed == jpkt.pack_ascii_frame(body, w, h, compress=compress)
        assert tpkt.unpack_ascii_frame(framed) == jpkt.unpack_ascii_frame(framed)


def test_packet_types_match():
    assert {t.name: int(t) for t in tpkt.PacketType} == \
        {t.name: int(t) for t in jpkt.PacketType}


# -- the command line ---------------------------------------------------------

ARGVS = [
    ["mirror"],
    ["mirror", "--test-pattern", "--snapshot", "--width", "80", "--height", "24"],
    ["mirror", "--file", "clip.mp4", "--loop", "--color-mode", "256", "--render-mode", "2",
     "--palette", "blocks", "--color-filter", "green", "--flip-x", "--flip-y", "--fps", "24",
     "--stdin-size", "640x480", "--max-frames", "5", "--show-fps", "--stretch", "--matrix",
     "--render-file", "out.y4m", "--tone-hz", "440", "--audio-wav", "a.wav",
     "--update-check", "--config", "c.toml", "--preset", "p"],
    ["mirror", "--color-mode", "auto"],
    ["mirror", "--color-mode", "TRUECOLOR", "--log-level", "DEV", "--log-json"],
    ["server"],
    ["server", "--port", "27300", "--host", "127.0.0.1", "--compress", "3",
     "--password", "pw", "--inspect-port", "9000", "--status", "--log-level", "DEBUG",
     "--ws-port", "8080", "--mdns", "--allowed-keys", "github:someone",
     "--gpg-keyring", "/tmp/kr", "--log-file", "s.log", "--grep", "tick"],
    ["client"],
    ["client", "127.0.0.1", "--port", "27224", "--audio", "--encrypt", "--no-compress",
     "--webrtc", "--h265", "--opus", "--audio-gain", "0.5", "--ssh-agent", "--no-media"],
    ["discovery-service"],
    ["discovery-service", "--db", "sessions.db", "--port", "1"],
    ["discovery", "--join", "a-b-c", "--acds", "1.2.3.4", "--stun", "h:1", "--view",
     "--p2p-dtls", "off", "--ring-interval", "2.5"],
    ["bench"],
    ["strings", "--count", "3", "--list-words"],
    ["query", "123", "--serve", "8000", "--force"],
    ["completions", "fish"],
    ["manpage"],
]

BAD_ARGVS = [
    [], ["nonsense"], ["mirror", "--wid", "3"], ["mirror", "--stdin-size", "640x0"],
    ["mirror", "--color-mode", "purple"], ["mirror", "--render-mode", "7"],
    ["server", "--snapshot"], ["completions", "tcsh"], ["query"],
]


def _namespace(main_mod, argv) -> dict:
    ns = vars(main_mod.build_parser().parse_args(argv))
    ns.pop("fn", None)  # the handler: the port's own, and only for its ported modes
    return ns


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:3]))
def test_parser_namespaces_match(argv):
    assert _namespace(tmain, argv) == _namespace(jmain, argv)


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=lambda a: " ".join(a[:3]) or "empty")
def test_parser_errors_match(argv, capsys):
    errors = []
    for mod in (jmain, tmain):
        with pytest.raises(SystemExit) as exc:
            mod.build_parser().parse_args(argv)
        errors.append((exc.value.code, capsys.readouterr().err))
    assert errors[0] == errors[1]


def test_parser_help_matches():
    jparser, tparser = jmain.build_parser(), tmain.build_parser()
    assert tparser.format_help() == jparser.format_help()
    jsub = jparser._subparsers._group_actions[0].choices
    tsub = tparser._subparsers._group_actions[0].choices
    assert list(tsub) == list(jsub)
    for mode in jsub:
        assert tsub[mode].format_help() == jsub[mode].format_help(), mode


# -- resize index tables --------------------------------------------------------

SIZES = [1, 2, 3, 7, 16, 31, 57, 64, 128, 203, 240, 480, 600, 1080, 1920, 3840]


@pytest.mark.parametrize("src", SIZES)
def test_resize_indices_match(src):
    assert taspect.CHAR_ASPECT == jaspect.CHAR_ASPECT
    for dst in SIZES:
        got, want = taspect.resize_indices(src, dst), jaspect.resize_indices(src, dst)
        assert got.dtype == want.dtype and np.array_equal(got, want), (src, dst)
        assert (taspect.fit_dimensions_pixel(src, dst, 203, 128)
                == jaspect.fit_dimensions_pixel(src, dst, 203, 128))


# -- audio sources and sinks -----------------------------------------------------


def _wav_pcm16(path, rate: int, channels: int) -> None:
    sig = (np.sin(2 * np.pi * 440 * np.arange(2400) / rate) * 16000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.repeat(sig, channels).tobytes())


def _wav_float(path) -> None:
    data = (0.25 * np.sin(2 * np.pi * 300 * np.arange(4000) / 32000)).astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, 32000, 32000 * 4, 4, 32)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
                     + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                     + b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("kind", ["tone", "silence", "wav16_24k_stereo", "wav16_48k_mono",
                                  "wav_float_32k"])
def test_audio_sources_match(kind, tmp_path):
    path = tmp_path / "in.wav"
    if kind.startswith("wav16"):
        _wav_pcm16(path, 24000 if "24k" in kind else 48000, 2 if "stereo" in kind else 1)
    elif kind == "wav_float_32k":
        _wav_float(path)
    sources = []
    for mod in (jaudiodev, taudiodev):
        if kind == "tone":
            sources.append(mod.open_audio_source(tone_hz=1000.0, amplitude=0.5))
        elif kind == "silence":
            sources.append(mod.SilenceSource())
        else:
            sources.append(mod.open_audio_source(wav=str(path)))
    for n in (480, 480, 7, 9600):  # 9600 wraps the looping files
        a, b = (src.read(n) for src in sources)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_file_sink_matches(tmp_path):
    buf = (0.3 * np.sin(np.arange(960) / 5)).astype(np.float32)
    for mod, name in ((jaudiodev, "j.f32"), (taudiodev, "t.f32")):
        sink = mod.open_audio_sink(str(tmp_path / name))
        sink.write(buf[:480])
        sink.write(buf[480:])
        sink.close()
    assert (tmp_path / "j.f32").read_bytes() == (tmp_path / "t.f32").read_bytes()
    with pytest.raises(taudiodev.AudioSourceUnavailable):
        taudiodev.open_audio_source(wav=str(tmp_path / "missing.wav"))
