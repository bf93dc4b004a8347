"""The plain reference: byte for byte against the port's CPU path, its
independence from the program, and the yardstick's byte counts."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import yardstick
from reference.control import rgb565
from reference.render import Reference

FORBIDDEN_IN_REFERENCE = {"jax", "jaxlib", "flax", "asciichat_tpu", "asciichat_tpu_torch"}
STANDARD = "   ...',;:clodxkO0KXNWM"
BLOCKS = "   ░░▒▒▓▓██"  # multi-byte glyphs: the truecolor path that always writes its SGR


def config(mode: str, width: int, height: int, palette: str = STANDARD) -> dict:
    return {"mode": mode, "palette": palette, "width": width, "height": height,
            "keep_aspect": True, "padding": True}


def frames(h: int, w: int, seed: int) -> np.ndarray:
    """Noise, flat blocks (runs and repeats), black (transparent half blocks)
    and few-valued noise (short runs) in one batch."""
    rng = np.random.default_rng(seed)
    out = np.zeros((4, h, w, 3), np.uint8)
    out[0] = rng.integers(0, 256, (h, w, 3))
    out[1] = 40
    out[1, h // 4: h // 2, w // 5: w // 2] = 0
    out[1, h // 2:, w // 2:] = (200, 10, 90)
    out[2] = rng.integers(0, 3, (h, w, 1)) * 60
    out[3] = rng.integers(0, 2, (h, w, 3)) * 255
    return out


def port_frames(batch: np.ndarray, mode: str, width: int, height: int, palette: str):
    from asciichat_tpu_torch.render.pipeline import AsciiRenderer
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
    render = RenderMode.HALF_BLOCK if mode.startswith("halfblock") else RenderMode.FOREGROUND
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, render)
    return AsciiRenderer(palette=palette, device="cpu").convert_batch(batch, width, height, caps)


@pytest.mark.parametrize("palette", [STANDARD, BLOCKS])
@pytest.mark.parametrize("shape", [(48, 80, 40, 12), (80, 48, 40, 12), (45, 61, 17, 9),
                                   (1080, 1920, 203, 64)])
@pytest.mark.parametrize("mode", ["truecolor_fg", "halfblock_truecolor"])
def test_reference_equals_the_port_on_the_cpu(mode, shape, palette):
    h, w, width, height = shape
    batch = frames(h, w, seed=h * w)
    ref = Reference(config(mode, width, height, palette), h, w)
    got = port_frames(batch, mode, width, height, palette)
    assert [ref.frame(f) for f in batch] == got


def test_geometry_of_the_cells():
    tc = Reference(config("truecolor_fg", 203, 64), 1080, 1920)
    hb = Reference(config("halfblock_truecolor", 203, 64), 1080, 1920)
    assert (tc.cells_w, tc.pixel_rows, tc.pad_w, tc.pad_h) == (203, 57, 0, 3)
    assert (hb.cells_w, hb.pixel_rows, hb.pad_w, hb.pad_h) == (203, 114, 0, 3)
    tall = Reference(config("truecolor_fg", 40, 12), 80, 48)
    assert tall.pad_w > 0


def test_yardstick_counts_the_records_work():
    tc = Reference(config("truecolor_fg", 203, 64), 1080, 1920)
    hb = Reference(config("halfblock_truecolor", 203, 64), 1080, 1920)
    # sampled pixels read once (3 B), records written once (4 B or 6 B a cell)
    assert yardstick.records_bytes(tc, 128) == 128 * (57 * 203 * 3 + 57 * 203 * 4)
    assert yardstick.records_bytes(hb, 128) == 128 * (114 * 203 * 3 + 57 * 203 * 6)


def test_rgb565_control_changes_most_colours():
    values = np.arange(256, dtype=np.uint8)
    px = np.stack([values] * 3, -1)[None]
    assert (rgb565(px) != px).any(-1).mean() > 0.9


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN_IN_REFERENCE, (path, name)


def test_reference_loads_nothing_of_the_program():
    probe = (
        "import sys, json, numpy as np; sys.path.insert(0, sys.argv[1]);"
        "from reference.render import Reference; from reference.control import Rgb565Reference;"
        "f = np.random.default_rng(0).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8);"
        "[[cls(json.loads(c), 48, 80).frame(x) for x in f]"
        " for c in sys.argv[2:] for cls in (Reference, Rgb565Reference)];"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    confs = [json.dumps(config(m, 40, 12)) for m in ("truecolor_fg", "halfblock_truecolor")]
    proc = subprocess.run([sys.executable, "-c", probe, str(BENCH_DIR), *confs],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(eval(proc.stdout.strip()))
    assert "reference" in loaded and not loaded & FORBIDDEN_IN_REFERENCE


# The server's tick: the grid, the filters, the 256-colour half-blocks, the
# frames of a tick and the yardstick of K3.

from reference import filters as ref_filters  # noqa: E402
from reference import grid  # noqa: E402
from reference.modes import halfblock_256  # noqa: E402
from reference.tick import TickReference  # noqa: E402

VGA = (640, 480)
HB = "▀".encode()


@pytest.mark.parametrize("sizes, terminal, want", [
    ([], (80, 24), (0, 0)),
    ([VGA], (80, 24), (1, 1)),
    ([VGA] * 2, (80, 24), (2, 1)),  # 40x24 cells fill 62.5%, 80x12 only 40%
    ([VGA] * 9, (100, 30), (4, 3)),  # 25x10 cells fill 90%, 33x10 78.8%, 20x15 46.7%
    ([VGA] * 9, (203, 64), (4, 3)),  # 50x21 cells fill 85.7%, 67x21 83.6%
    ([VGA] * 9, (80, 24), (1, 9)),  # no layout has cells of 20x10: one column
])
def test_grid_layout_of_hand_worked_cases(sizes, terminal, want):
    assert grid.grid_layout(sizes, *terminal) == want


def test_composite_maps_of_a_hand_worked_case():
    """One 4x2 source in a 4x2 terminal: a 4x4 composite, the source fitted
    4 wide and 2 high, centred on rows 1-2; black above and below."""
    src, sy, sx = grid.composite_maps([(4, 2)], 4, 2)
    assert src.tolist() == [[-1] * 4, [0] * 4, [0] * 4, [-1] * 4]
    assert sy[1:3].tolist() == [[0] * 4, [1] * 4]
    assert sx[1:3].tolist() == [[0, 1, 2, 3]] * 2
    # the receiver's frame: 4 cells by 2 rows, rows 0 and 2 of the composite
    rsrc, rsy, rsx, pad_w, pad_h = grid.receiver_maps([(4, 2)], 4, 2, 1, True)
    assert rsrc.tolist() == [[-1] * 4, [0] * 4] and (pad_w, pad_h) == (0, 0)
    assert rsy[1].tolist() == [1] * 4 and rsx[1].tolist() == [0, 1, 2, 3]


def test_grid_maps_equal_the_port_compositor():
    from asciichat_tpu_torch.ops import compositor
    for sizes in ([VGA] * 9, [VGA, (320, 240), (800, 600)], [(64, 48)] * 3, [(100, 20), (20, 100)]):
        for terminal in ((100, 30), (80, 24), (203, 64), (60, 20), (50, 16), (40, 12)):
            plan = compositor.plan_composite(sizes, *terminal)
            src, sy, sx = grid.composite_maps(sizes, *terminal)
            assert (plan.cols, plan.rows) == grid.grid_layout(sizes, *terminal)
            assert np.array_equal(plan.client_idx, src)
            live = src >= 0
            assert np.array_equal(plan.src_y[live], sy[live])
            assert np.array_equal(plan.src_x[live], sx[live])


def test_filters_equal_the_port_filters():
    from asciichat_tpu_torch.ops import filters as port_filters
    px = np.random.default_rng(3).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    for name in ref_filters.REGISTRY:
        assert np.array_equal(ref_filters.apply(px, name),
                              port_filters.apply_color_filter_reference(px, name)), name
    # tint on black: gray (770 + 3000 + 870) >> 8 = 18, 221 * 18 // 255 = 15
    assert ref_filters.apply(np.array([[10, 20, 30]], np.uint8), "teal").tolist() == [[0, 15, 15]]


RED, BLUE, BLACK, NEAR = (255, 0, 0), (0, 0, 255), (0, 0, 0), (1, 1, 1)


@pytest.mark.parametrize("top, bottom, want", [
    # black on black is spaces; red over blue, a run of two, is two half blocks
    ([BLACK, RED, RED], [BLACK, BLUE, BLUE],
     b" \x1b[38;5;196m\x1b[48;5;21m" + HB * 2 + b"\x1b[0m"),
    # a run is judged transparent by its first cell: near black shares black's index
    ([BLACK, NEAR], [BLACK, NEAR], b"  \x1b[0m"),
    ([NEAR, BLACK], [NEAR, BLACK], b"\x1b[38;5;232m\x1b[48;5;232m" + HB * 2 + b"\x1b[0m"),
    # a colour after a transparent run starts from no colour; a reset ends the colours first
    ([RED, BLACK, RED], [RED, BLACK, RED],
     b"\x1b[38;5;196m\x1b[48;5;196m" + HB + b"\x1b[0m \x1b[38;5;196m\x1b[48;5;196m" + HB
     + b"\x1b[0m"),
    # ten equal cells: one half block and a repeat of nine
    ([RED] * 10, [BLUE] * 10, b"\x1b[38;5;196m\x1b[48;5;21m" + HB + b"\x1b[9b\x1b[0m"),
])
def test_halfblock_256_of_hand_worked_rows(top, bottom, want):
    assert halfblock_256.render(np.array([top, bottom], np.uint8), "") == want


def test_halfblock_256_quantizes_as_xterm_and_keeps_an_odd_last_row():
    grey, cube = np.array([[[100, 110, 120]], [[0, 128, 255]]], np.uint8)
    assert halfblock_256.index256(grey).tolist() == [232 + 110 * 23 // 255]
    assert halfblock_256.index256(cube).tolist() == [16 + 0 + 6 * 2 + 5]
    # three pixel rows: the last is its own bottom
    out = halfblock_256.render(np.array([[RED], [BLUE], [BLUE]], np.uint8), "")
    assert out == (b"\x1b[38;5;196m\x1b[48;5;21m" + HB + b"\x1b[0m\n"
                   b"\x1b[38;5;21m\x1b[48;5;21m" + HB + b"\x1b[0m")


@pytest.mark.parametrize("shape", [(48, 80, 40, 12), (45, 61, 17, 9), (120, 160, 203, 64)])
def test_halfblock_256_equals_the_port_on_the_cpu(shape):
    h, w, width, height = shape
    batch = frames(h, w, seed=h + w)
    ref = Reference(config("halfblock_256", width, height), h, w)
    from asciichat_tpu_torch.render.pipeline import AsciiRenderer
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
    caps = TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.HALF_BLOCK)
    got = AsciiRenderer(device="cpu").convert_batch(batch, width, height, caps)
    assert [ref.frame(f) for f in batch] == got


def server_nine() -> dict:
    return json.loads((BENCH_DIR / "configs" / "server-9.json").read_text())


def test_tick_reference_equals_the_port_server_on_the_cpu(monkeypatch):
    """One tick of the port's server on the CPU, with the nine clients of
    server-9 and noise for webcams, sends each client the reference's frame."""
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    from asciichat_tpu_torch.apps import server
    from asciichat_tpu_torch.net import packet, protocol
    from asciichat_tpu_torch.ops import filters as port_filters
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
    conf = server_nine()
    rng = np.random.default_rng(9)
    cams = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in conf["clients"]]
    for cam in cams[::2]:
        cam[100:300, 200:400] = 0  # black on black: transparent half blocks
    srv = server.AsciiChatServer(palette=conf["palette"])
    clients = []
    for i, c in enumerate(conf["clients"]):
        sent = []
        sink = type("Sink", (), {"send_nowait": lambda self, t, p, *, byte_cap=None, s=sent:
                                 s.append(p) or True})()
        client = server.ClientState(i + 1, sink)
        client.wire_caps = protocol.WireCapabilities(
            caps=TerminalCapabilities(ColorLevel[c["color_level"]], RenderMode[c["render_mode"]]),
            width=c["width"], height=c["height"], palette_custom=c["palette"],
            palette_type=5 if c["palette"] else 0, capabilities_mask=1,
            color_filter=port_filters.FILTER_NAMES.index(c["filter"]))
        client.filter_name, client.has_caps, client.streaming = c["filter"], True, True
        client.video.commit(cams[i])
        clients.append((client, sent))
    srv._render_tick([c for c, _ in clients])
    want = TickReference(conf, [VGA] * 9).frames(cams)
    for (client, sent), frame in zip(clients, want):
        assert len(sent) == 1
        got, w, h, _ = packet.unpack_ascii_frame(sent[0])
        assert got == frame and (w, h) == (client.wire_caps.width, client.wire_caps.height)


def test_tick_reference_shares_composites_and_frames():
    ref = TickReference(server_nine(), [VGA] * 9)
    assert len(ref.views) == 4  # 100x30 with two palettes, 80x24, 203x64
    assert len({(view.key, name) for view, name in ref.receivers}) == 9
    cams = [np.zeros((480, 640, 3), np.uint8)] * 9
    out = ref.frames(cams)
    assert out[0] == out[7]  # a1 and d1: half blocks take no palette, no filter
    assert out[0].startswith(b"\n" * 15)  # 60 pixel rows fitted as 30 of 60: 15 on top


def test_yardstick_counts_k3_work():
    """Two receivers of one 4x2 source in a 4x2 terminal, truecolor: 4
    distinct pixels read (3 B each); two filters, 2 rows x 4 cells of
    records each (4 B a cell)."""
    conf = {"palette": STANDARD, "padding": True, "clients": [
        {"width": 4, "height": 2, "mode": "truecolor_fg", "palette": "", "filter": f}
        for f in ("none", "teal")]}
    assert yardstick.k3_bytes(TickReference(conf, [(4, 2)])) == 3 * 4 + 2 * 2 * 4 * 4


def test_acip_reader_against_the_port_packer():
    from asciichat_tpu_torch.net import packet
    from harness import acip
    assert acip.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    frame = bytes(range(256)) * 9
    payload = packet.pack_ascii_frame(frame, 100, 30, compress=False)
    assert payload == acip.header(frame, 100, 30) + frame
    assert acip.unpack(payload) == (100, 30, packet.crc32c(frame), frame)
    with pytest.raises(ValueError):
        acip.unpack(payload[:-1])  # a frame shorter than its header says
    flagged = bytearray(payload)
    flagged[23] |= acip.COMPRESSED  # the flags word's low byte
    with pytest.raises(ValueError):
        acip.unpack(bytes(flagged))
