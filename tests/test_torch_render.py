"""The port's mirror convert (render/pipeline.py, models/mirror.py,
apps/main.py) against the JAX package's AsciiRenderer and the oracle: ANSI
bytes must be identical, for every mode, two UTF-8 palettes, and the
stretch and padding cases of test_golden_render.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu.render import emitter, oracle
from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.pipeline import AsciiRenderer as JaxRenderer
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.apps import main as tmain
from asciichat_tpu_torch.models.mirror import MirrorSession
from asciichat_tpu_torch.ops import cells as tcells
from asciichat_tpu_torch.net.update_checker import UpdateChecker
from asciichat_tpu_torch.ops import filters as tfilt
from asciichat_tpu_torch.render.pipeline import AsciiRenderer

from conftest import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ORACLE_FNS = {
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
}


def _native_size(frames: np.ndarray, mode: str, palette: str) -> list[bytes]:
    """The port's records at the frames' own size, through the shared emitter."""
    recs = tcells.render_cells(torch.from_numpy(frames), tcells.ramp_for_palette(palette),
                               dst_h=frames.shape[1], dst_w=frames.shape[2], mode=mode)
    return emitter.emit_frames(tcells.records_to_numpy(recs), mode, palette)


@pytest.mark.parametrize("mode", tcells.MODES)
def test_mode_matches_oracle(mode):
    frames = np.random.default_rng(42).integers(0, 256, (2, 7, 19, 3), dtype=np.uint8)
    frames[1, :, :9] = 0  # black runs (REP and transparent paths)
    got = _native_size(frames, mode, pal.DEFAULT_PALETTE)
    for i in range(2):
        assert got[i] == ORACLE_FNS[mode](frames[i], pal.DEFAULT_PALETTE), i


@pytest.mark.parametrize("palette_name", ["blocks", "cool"])
@pytest.mark.parametrize("mode", ["mono", "truecolor_fg", "256color", "16color"])
def test_utf8_palettes(mode, palette_name):
    palette = pal.BUILTIN_PALETTES[palette_name]
    frame = synthetic_frame(10, 24, seed=9)[None]
    assert _native_size(frame, mode, palette)[0] == ORACLE_FNS[mode](frame[0], palette)


CAPS = [
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.BACKGROUND),
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.HALF_BLOCK),
]


@pytest.mark.parametrize("caps", CAPS, ids=lambda c: c.renderer_key())
def test_convert_batch_matches_jax_and_oracle(caps):
    frames = np.stack([synthetic_frame(48, 64, seed=s) for s in (11, 12)])
    got = AsciiRenderer(device=CPU).convert_batch(frames, 46, 14, caps)
    assert got == JaxRenderer().convert_batch(frames, 46, 14, caps)
    for i in range(2):
        assert got[i] == oracle.ascii_convert_with_capabilities(frames[i], 46, 14, caps)


@pytest.mark.parametrize("palette_name", ["blocks", "cool"])
def test_convert_utf8_palette_matches_jax(palette_name):
    palette = pal.BUILTIN_PALETTES[palette_name]
    frame = synthetic_frame(30, 40, seed=3)
    caps = TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.FOREGROUND)
    got = AsciiRenderer(palette, device=CPU).convert(frame, 33, 11, caps)
    assert got == JaxRenderer(palette).convert(frame, 33, 11, caps)


def test_stretch_and_no_padding():
    frame = synthetic_frame(30, 40, seed=2)
    renderer = AsciiRenderer(device=CPU)
    caps = TerminalCapabilities(wants_padding=False)
    assert (renderer.convert(frame, 50, 20, caps)
            == oracle.ascii_convert_with_capabilities(frame, 50, 20, caps))
    caps2 = TerminalCapabilities()
    assert (renderer.convert(frame, 50, 20, caps2, stretch=True)
            == oracle.ascii_convert_with_capabilities(frame, 50, 20, caps2, stretch=True))


def test_batch_consistency_and_tensor_input():
    frames = np.stack([synthetic_frame(24, 32, seed=s) for s in range(4)])
    renderer = AsciiRenderer(device=CPU)
    caps = TerminalCapabilities()
    batched = renderer.convert_batch(frames, 40, 12, caps)
    assert batched == [renderer.convert(f, 40, 12, caps) for f in frames]
    assert renderer.convert_batch(torch.from_numpy(frames), 40, 12, caps) == batched


def test_convert_batch_rejects_unbatched_frame():
    with pytest.raises(ValueError, match=r"\[B,H,W,3\]"):
        AsciiRenderer(device=CPU).convert_batch(synthetic_frame(24, 32), 40, 12,
                                                TerminalCapabilities())


class _StillSource:
    fps = 30.0

    def __init__(self, frame):
        self.frame = frame

    def read(self):
        return self.frame

    def close(self):
        pass


@pytest.mark.parametrize("color_filter", ["none", "green", "black"])
def test_mirror_snapshot_matches_oracle(color_filter, capfdbinary):
    frame = synthetic_frame(60, 80, seed=6)
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
    session = MirrorSession(_StillSource(frame), caps, 40, 12, pal.DEFAULT_PALETTE,
                            color_filter=color_filter, flip_x=True, device=CPU)
    out = session.run_snapshot()
    want_frame = tfilt.apply_color_filter_reference(frame[:, ::-1], color_filter)
    assert out == oracle.ascii_convert_with_capabilities(want_frame, 40, 12, caps)


def test_mirror_matrix_not_ported():
    """The mirror's ``matrix=True``: the snapshot is the oracle's bytes for
    the frame that the rain overlaid (tests/test_torch_rain.py holds the
    overlay to the JAX package's)."""
    frame = synthetic_frame(60, 80, seed=7)
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
    session = MirrorSession(_StillSource(frame), caps, 40, 12, pal.DEFAULT_PALETTE,
                            matrix=True, device=CPU)
    seen = []
    convert = session.renderer.convert
    session.renderer.convert = lambda f, *a, **k: seen.append(np.asarray(f)) or convert(f, *a, **k)
    out = session.run_snapshot()
    assert seen[0].shape == frame.shape and not np.array_equal(seen[0], frame)
    assert out == oracle.ascii_convert_with_capabilities(seen[0], 40, 12, caps)


def test_bench_ported_since_run(monkeypatch):
    """``bench``, the last mode that ``test_unported_modes_exit_nonzero``
    turned away, has a handler: main() returns what apps/bench.main returns
    (tests/test_torch_bench.py runs the mode itself)."""
    from asciichat_tpu_torch.apps import bench

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)  # main() installs its own
    monkeypatch.setattr(bench, "main", lambda: 7)
    assert tmain.main(["bench"]) == 7


def test_completions_ported_since_run(capsys, monkeypatch):
    """``completions bash``, which ``test_unported_modes_exit_nonzero``
    turned away, prints the JAX package's script
    (tests/test_torch_cli.py holds every shell and the man page)."""
    from asciichat_tpu.utils import options as jopt

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)  # main() installs its own
    assert tmain.main(["completions", "bash"]) == 0
    assert capsys.readouterr().out == \
        jopt.generate_completions(jopt.default_registry(), "bash") + "\n"


@pytest.mark.parametrize("mode", ["discovery", "client-webrtc", "discovery-service"])
def test_modes_ported_since_run(mode, capsys, monkeypatch, tmp_path):
    """The modes that ``test_unported_modes_exit_nonzero`` turned away run:
    ``discovery-service`` greets a connection with its signed hello,
    ``discovery`` creates a session and prints its string, and
    ``client --webrtc`` (in process) prints frames from a ``server
    --ws-port`` over a DataChannel and exits 0. The processes run with
    ``asciichat_tpu`` blocked (tests/test_torch_discovery.py has the
    whole session, with a joiner and host failover)."""
    import asyncio

    from asciichat_tpu.net import packet as jpkt
    from asciichat_tpu.net.discovery import validate_session_string
    from asciichat_tpu.net.transport import connect_tcp

    from test_torch_discovery import LIMIT, _accepts, _free_port, _Proc, _service

    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    procs = []
    try:
        if mode == "client-webrtc":
            ws_port = _free_port()
            procs.append(_Proc(tmp_path, "server", "--host", "127.0.0.1", "--port",
                               str(_free_port()), "--ws-port", str(ws_port),
                               "--log-level", "WARNING"))
            procs[0].wait_for(lambda: _accepts(ws_port), "the server's ws listener")
            argv = ["client", "127.0.0.1", "--port", str(ws_port), "--webrtc",
                    "--test-pattern", "--max-frames", "3", "--no-reconnect",
                    "--width", "40", "--height", "10", "--log-level", "WARNING"]
            assert tmain.main(argv) == 0
            assert capsys.readouterr().out.count("\x1b[") > 100
            return
        acds, acds_port = _service(tmp_path)
        procs.append(acds)
        if mode == "discovery-service":
            async def hello():
                t = await connect_tcp("127.0.0.1", acds_port)
                try:
                    return (await asyncio.wait_for(t.recv(), LIMIT))[0]
                finally:
                    await t.close()

            assert asyncio.run(hello()) == jpkt.PacketType.ACIP_ACDS_HELLO
            return
        host = _Proc(tmp_path, "discovery", "--acds", "127.0.0.1", "--acds-port",
                     str(acds_port), "--port", str(_free_port()), "--log-level", "WARNING")
        procs.append(host)
        assert validate_session_string(host.session())
    finally:
        for proc in procs:
            proc.stop()


@pytest.mark.parametrize("extra, fps", [([], 30), (["--tone-hz", "440"], 30),
                                        (["--fps", "0.4"], 1)],
                         ids=["plain", "tone", "fractional-fps"])
def test_mirror_cli_render_file(extra, fps, monkeypatch, capsys, tmp_path):
    """``mirror --render-file`` on the plain versions writes --max-frames
    frames to a Y4M file whose rate is a whole number >= 1."""
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    out = tmp_path / "clip.y4m"
    argv = ["mirror", "--test-pattern", "--render-file", str(out), "--max-frames", "4",
            "--width", "20", "--height", "6", *extra]
    assert tmain.main(argv) == 0
    assert capsys.readouterr().out == f"rendered 4 frames to {out}\n"
    data = out.read_bytes()
    assert data.count(b"FRAME\n") == 4
    assert f" F{fps}:1 ".encode() in data.split(b"\n", 1)[0]


@pytest.mark.parametrize("flags, want", [(["--ws-port", "8123"], (8123, False)),
                                         (["--mdns"], (None, True))],
                         ids=["ws-port", "mdns"])
def test_server_cli_passes_ws_port_and_mdns(flags, want, monkeypatch):
    """``server --ws-port`` and ``--mdns`` reach the port's server."""
    from asciichat_tpu_torch.apps import server

    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    seen = []

    async def run(self):
        seen.append((self.ws_port, self.mdns))

    monkeypatch.setattr(server.AsciiChatServer, "run", run)
    assert tmain.main(["server", "--port", "0", *flags]) == 0
    assert seen == [want]


def test_client_cli_ws_dials_websocket(monkeypatch):
    from asciichat_tpu_torch.apps import client

    seen = []

    async def run(self, max_frames=None):
        seen.append(self.use_ws)

    monkeypatch.setattr(client.AsciiChatClient, "run", run)
    assert tmain.main(["client", "127.0.0.1", "--ws", "--no-media"]) == 0
    assert seen == [True]


@pytest.mark.parametrize("announced", [True, False], ids=["found", "nothing"])
def test_client_cli_browse(announced, monkeypatch, capsys):
    """``client --browse`` lists what mDNS finds, and exits 1 when nothing
    is announced."""
    from asciichat_tpu_torch.net import mdns

    svc = mdns.DiscoveredService("asciichat", "192.0.2.4", 27224, {"ver": "1", "ws": "8080"})
    monkeypatch.setattr(mdns, "discover", lambda timeout: [svc] if announced else [])
    assert tmain.main(["client", "--browse"]) == (0 if announced else 1)
    out = capsys.readouterr().out
    assert out == ("asciichat  192.0.2.4:27224  {'ver': '1', 'ws': '8080'}\n" if announced
                   else "no ascii-chat servers announced on this LAN\n")


def test_mirror_cli_snapshot_without_jax():
    """The port's CLI renders a snapshot with JAX unimportable."""
    code = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None; "
            "sys.argv = ['main', 'mirror', '--test-pattern', '--snapshot', '--width', "
            "'40', '--height', '10', '--color-mode', 'NONE', '--stretch']; "
            "runpy.run_module('asciichat_tpu_torch.apps.main', run_name='__main__')")
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, timeout=180)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    lines = out.stdout.decode().rstrip("\n").split("\n")
    assert len(lines) == 10
    assert all(len(line) == 40 for line in lines)


def test_mirror_cli_matrix_snapshot(monkeypatch, capfdbinary):
    """``mirror --test-pattern --matrix --snapshot`` on the plain versions."""
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    argv = ["mirror", "--test-pattern", "--matrix", "--snapshot", "--width", "40",
            "--height", "10", "--color-mode", "NONE", "--stretch"]
    assert tmain.main(argv) == 0
    lines = capfdbinary.readouterr().out.rstrip(b"\n").split(b"\n")
    assert len(lines) == 10 and all(len(line) == 40 for line in lines)


def _fake_mode(monkeypatch):
    """Stand in for the mirror, writing MODE to stderr when it starts."""
    def mode(args):
        print("MODE", file=sys.stderr)
        return 0
    monkeypatch.setattr(tmain, "cmd_mirror", mode)


def test_update_check_prints_the_banner_first(monkeypatch, capsys):
    _fake_mode(monkeypatch)
    monkeypatch.setattr(UpdateChecker, "check", lambda self, force=False: "v99.0.0")
    assert tmain.main(["mirror", "--update-check"]) == 0
    err = capsys.readouterr().err
    assert "update available: v99.0.0" in err
    assert err.index("update available") < err.index("MODE")


def _refuse(*args, **kwargs):
    raise OSError("no network")


@pytest.mark.parametrize("where", ["fetch", "check"])
def test_update_check_is_silent_on_failure(where, monkeypatch, capsys, tmp_path):
    """A failed fetch (no cache: the checker asks the network, which the
    fake refuses) and a checker that raises both leave no trace."""
    _fake_mode(monkeypatch)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    monkeypatch.setattr(UpdateChecker, "fetch_latest" if where == "fetch" else "check", _refuse)
    assert tmain.main(["mirror", "--update-check"]) == 0
    assert capsys.readouterr().err == "MODE\n"


def test_no_update_check_without_the_flag(monkeypatch, capsys):
    _fake_mode(monkeypatch)
    monkeypatch.setattr(UpdateChecker, "check", _refuse)
    assert tmain.main(["mirror"]) == 0
    assert capsys.readouterr().err == "MODE\n"
