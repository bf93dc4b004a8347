"""The port stands alone: no module of asciichat_tpu_torch, nor
chip_smoke.py, imports the JAX package ``asciichat_tpu`` (eagerly or
lazily), PIL only inside the image decoders, every one of them imports with
``asciichat_tpu``, ``jax``,
``jaxlib`` and ``PIL`` unimportable, ``mirror --render-file`` writes its
frames so, and the port's server, started in a process where
``asciichat_tpu`` cannot be imported, serves a plaintext and an encrypted
client frames equal to the oracle, and so it does to the port's
command-line client (with its audio capture chain) over TCP and WebSocket,
itself run with ``asciichat_tpu`` blocked. With ``cryptography`` blocked
too, ``server --ws-port`` starts, serves the page and a WebSocket client and
answers ``POST /webrtc/offer`` as the JAX server does without signaling,
and ``client --webrtc`` exits 1 with a one-line message. ``completions``
prints the JAX package's script, and the server under a forced mesh
(``ASCIICHAT_FORCE_MESH``, ``ASCIICHAT_MESH_SPACE``) serves oracle frames
and answers ``query``, each process with ``asciichat_tpu`` blocked. The raw
clients and the oracle here are the JAX package's: the tests are not the
port."""

import ast
import asyncio
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from asciichat_tpu.net import packet as pkt
from asciichat_tpu.net import protocol as proto
from asciichat_tpu.net.transport import connect_tcp
from asciichat_tpu.ops import compositor
from asciichat_tpu.render import oracle
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

from conftest import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "asciichat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "tools").glob("torch_*.py")))
BLOCK = ("import sys\n"
         "for name in ('asciichat_tpu', 'jax', 'jaxlib', 'PIL'):\n"
         "    sys.modules[name] = None\n")
# PIL: imported only inside the two image decoders of runtime/ (an image
# --file, an MJPEG camera), never at a module's top and never on the
# --render-file path, whose glyph atlas is a committed file
LAZY_PIL = {"asciichat_tpu_torch/runtime/framesource.py": 2,
            "asciichat_tpu_torch/runtime/webcam.py": 1}


def _jax_package(name: str) -> bool:
    return name == "asciichat_tpu" or name.startswith("asciichat_tpu.")


def _imports(path: Path, root: str, nodes) -> list[str]:
    """Every import of the package ``root`` among ``nodes`` of ``path``,
    and every ``importlib.import_module`` / ``__import__`` of it by a
    literal name."""
    found = []
    for node in nodes:
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if called in ("import_module", "__import__") and isinstance(arg, ast.Constant):
                names = [str(arg.value)]
        found += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] == root]
    return found


def _imports_of_the_jax_package(path: Path) -> list[str]:
    """Every import of ``asciichat_tpu`` in ``path``, at any depth."""
    return _imports(path, "asciichat_tpu", ast.walk(ast.parse(path.read_text(), str(path))))


def test_no_source_of_the_port_imports_the_jax_package():
    assert len(PORT_FILES) > 40
    tools = {f"torch_soak_{name}.py" for name in ("common", "latency", "nine", "thirtytwo",
                                                  "mixed")} | {"torch_gen_ansi_corpus.py"}
    assert tools <= {path.name for path in PORT_FILES}
    found = [hit for path in PORT_FILES for hit in _imports_of_the_jax_package(path)]
    assert not found, found


# JAX modules the port replaced rather than copied (ROADMAP.md, "Every module
# of the JAX package and its counterpart")
REPLACED = {"ops/pallas_resize.py": "asciichat_tpu_torch/ops/resize.py",
            "runtime/native_build.py": "asciichat_tpu_torch/runtime/kernel_build.py",
            "utils/jaxcache.py": "asciichat_tpu_torch/runtime/kernel_build.py"}


def test_every_jax_module_has_a_counterpart():
    """Each file of asciichat_tpu/ has one in the port at its relative
    path, or a named replacement that exists."""
    jax_dir = REPO / "asciichat_tpu"
    files = sorted(str(f.relative_to(jax_dir)) for f in jax_dir.rglob("*")
                   if f.is_file() and f.suffix in (".py", ".js", ".html", ".css"))
    assert len(files) > 90
    missing = [f for f in files if not (REPO / "asciichat_tpu_torch" / f).is_file()
               and not (f in REPLACED and (REPO / REPLACED[f]).is_file())]
    assert not missing, missing
    assert all(not (REPO / "asciichat_tpu_torch" / f).exists() for f in REPLACED)


def test_pil_is_imported_only_by_the_image_decoders():
    tops, lazy = [], {}
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), str(path))
        tops += _imports(path, "PIL", tree.body)
        hits = _imports(path, "PIL", ast.walk(tree))
        if hits:
            lazy[str(path.relative_to(REPO))] = len(hits)
    assert not tops, tops
    assert lazy == LAZY_PIL


IMPORT_ALL = BLOCK + """
import importlib, pkgutil
import asciichat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(asciichat_tpu_torch.__path__,
                                               "asciichat_tpu_torch.")]
assert "asciichat_tpu_torch.ops.rain" in names, names
slice_modules = {"asciichat_tpu_torch." + m for m in (
    "net.stun", "net.sdp", "net.sctp", "net.dtls", "net.webrtc", "net.datachannel",
    "net.rate_limit", "net.discovery", "net.consensus", "net.upnp", "apps.acds",
    "apps.discovery", "utils.dumps", "apps.query", "parallel.mesh", "runtime.device_stream",
    "apps.bench", "ops.emit", "render.validator", "utils.framefd", "utils.lifecycle",
    "web.jsrun")}
assert slice_modules <= set(names), slice_modules - set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split(".")[0] in ("asciichat_tpu", "jax", "jaxlib", "PIL")]
assert not loaded, loaded
print(len(names))
"""


def _env() -> dict:
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def test_every_module_imports_without_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 50  # every module was walked


def test_mirror_matrix_without_the_jax_package():
    """``mirror --matrix`` (ops/rain.py on the plain versions) renders a
    snapshot with ``asciichat_tpu`` blocked."""
    code = BLOCK + ("from asciichat_tpu_torch.apps.main import main\n"
                    "sys.exit(main(['mirror', '--test-pattern', '--matrix', '--snapshot', "
                    "'--width', '40', '--height', '10', '--color-mode', 'NONE', '--stretch']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, timeout=180)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    lines = out.stdout.decode().rstrip("\n").split("\n")
    assert len(lines) == 10 and all(len(line) == 40 for line in lines)


def test_mirror_render_file_without_the_jax_package_or_pil(tmp_path):
    """``mirror --render-file`` (the committed glyph atlas; no PIL) writes
    its frames with ``asciichat_tpu`` and ``PIL`` blocked."""
    out = tmp_path / "clip.y4m"
    code = BLOCK + ("sys.modules['PIL'] = None\n"
                    "from asciichat_tpu_torch.apps.main import main\n"
                    f"code = main(['mirror', '--test-pattern', '--render-file', {str(out)!r}, "
                    "'--max-frames', '3', '--width', '20', '--height', '6'])\n"
                    "assert 'PIL' not in [m.split('.')[0] for m, mod in sys.modules.items() "
                    "if mod is not None]\n"
                    "sys.exit(code)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, timeout=180)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    assert run.stdout.decode() == f"rendered 3 frames to {out}\n"
    assert out.read_bytes().count(b"FRAME\n") == 3


# -- the server with asciichat_tpu blocked ------------------------------------

HB_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
TERM_W, TERM_H = 40, 12
WAIT_S = 90.0
PASSWORD = "sekrit"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_server(port: int, *extra: str, block: str = BLOCK) -> subprocess.Popen:
    code = block + (
        "from asciichat_tpu_torch.apps.main import main\n"
        f"sys.exit(main(['server', '--host', '127.0.0.1', '--port', '{port}', "
        f"'--log-level', 'WARNING', *{list(extra)!r}]))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    _wait_listening(proc, port)
    return proc


def _wait_listening(proc: subprocess.Popen, port: int) -> None:
    """Wait until ``port`` accepts, failing if ``proc`` exits first."""
    end = time.monotonic() + WAIT_S
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: "
                                 f"{proc.stderr.read().decode(errors='replace')[-3000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if time.monotonic() > end:
                proc.kill()
                raise AssertionError("the server never accepted a connection") from None
            time.sleep(0.1)


async def _session(port: int, encrypted: bool, frame: np.ndarray, want: bytes) -> None:
    raw = await connect_tcp("127.0.0.1", port)
    t = raw
    if encrypted:
        from asciichat_tpu.net.crypto import CryptoContext
        from asciichat_tpu.net.handshake import SecureChannel, client_handshake

        ctx = CryptoContext()
        ctx.set_password(PASSWORD)
        assert await client_handshake(raw, ctx, PASSWORD)
        t = SecureChannel(raw, ctx, initiator=True)
    try:
        wire = proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                      capabilities_mask=0x1)  # frames uncompressed
        await t.send(pkt.PacketType.CLIENT_CAPABILITIES, wire.pack())
        await t.send(pkt.PacketType.IMAGE_FRAME,
                     pkt.pack_image_frame(frame.tobytes(), frame.shape[1], frame.shape[0]))
        loop = asyncio.get_running_loop()
        end = loop.time() + WAIT_S
        while True:
            ptype, payload = await asyncio.wait_for(t.recv(), max(0.0, end - loop.time()))
            if (ptype == pkt.PacketType.ASCII_FRAME
                    and pkt.unpack_ascii_frame(payload)[0] == want):
                return
    finally:
        await raw.close()


@pytest.mark.parametrize("encrypted", [False, True], ids=["plaintext", "encrypted"])
def test_server_serves_without_the_jax_package(encrypted):
    frame = synthetic_frame(48, 64, seed=21)
    plan = compositor.plan_composite([(64, 48)], TERM_W, TERM_H)
    want = oracle.ascii_convert_with_capabilities(
        compositor.composite_reference(frame[None], plan), TERM_W, 2 * TERM_H, HB_TRUECOLOR)
    port = _free_port()
    proc = _start_server(port, *(("--password", PASSWORD) if encrypted else ()))
    try:
        asyncio.run(asyncio.wait_for(_session(port, encrypted, frame, want), 2 * WAIT_S))
        assert proc.poll() is None, "the server exited during the session"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        err = proc.stderr.read().decode(errors="replace")
        proc.stderr.close()
    assert "refused" not in err and "Traceback" not in err, err[-3000:]


@pytest.mark.parametrize("transport", ["plaintext", "encrypted", "websocket"])
def test_client_without_the_jax_package(transport, tmp_path):
    """``apps.main client`` (runtime/audiodev's tone through the capture
    chain, on the plain version) against the port's server, both with
    ``asciichat_tpu`` blocked, over TCP in the clear and encrypted, and over
    WebSocket (``server --ws-port``, ``client --ws``): exits 0 after
    --max-frames, its last frame byte-identical to the oracle."""
    encrypted = transport == "encrypted"
    if encrypted:
        pytest.importorskip("cryptography")
    frame = synthetic_frame(48, 64, seed=24)
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK,
                                wants_padding=False, utf8_support=True)  # piped stdout
    plan = compositor.plan_composite([(64, 48)], TERM_W, TERM_H)
    want = oracle.ascii_convert_with_capabilities(
        compositor.composite_reference(frame[None], plan), TERM_W, 2 * TERM_H, caps)
    feed = tmp_path / "frames.rgb"
    feed.write_bytes(frame.tobytes() * 600)
    crypto = ("--password", PASSWORD) if encrypted else ()
    port = _free_port()
    if transport == "websocket":
        ws_port = _free_port()
        proc = _start_server(port, "--ws-port", str(ws_port))
        _wait_listening(proc, ws_port)
        dial = ("--port", str(ws_port), "--ws")
    else:
        proc = _start_server(port, *crypto)
        dial = ("--port", str(port))
    argv = ["client", "127.0.0.1", *dial, "--stdin-size", "64x48",
            "--no-compress", "--no-reconnect", "--max-frames", "20", "--tone-hz", "440",
            "--width", str(TERM_W), "--height", str(TERM_H), "--render-mode", "2",
            "--color-mode", "truecolor", "--log-level", "WARNING",
            *(("--encrypt", *crypto) if encrypted else ())]
    code = BLOCK + ("from asciichat_tpu_torch.apps.main import main\n"
                    f"sys.exit(main({argv!r}))\n")
    try:
        with open(feed, "rb") as stdin:
            out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                 env=dict(_env(), LANG="C.UTF-8"), stdin=stdin,
                                 capture_output=True, timeout=2 * WAIT_S)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    err = out.stderr.decode(errors="replace")
    assert out.returncode == 0, err[-3000:]
    assert out.stdout.endswith(want + b"\n"), err[-2000:]
    assert "Traceback" not in err, err[-3000:]


# -- without cryptography -------------------------------------------------------

NO_CRYPTO = BLOCK + "sys.modules['cryptography'] = None\n"


async def _http(port: int, request: bytes) -> tuple[bytes, bytes]:
    """One HTTP request: the status line and the body."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), WAIT_S)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.split(b"\r\n", 1)[0], body


def test_server_with_ws_port_starts_without_cryptography():
    """``server --ws-port`` with ``cryptography`` (and ``asciichat_tpu``)
    blocked starts, serves the page and a WebSocket client frames, and
    serves no WebRTC signaling: ``POST /webrtc/offer`` gets the answer the
    JAX server gives where its signaling is unavailable (400 Bad Request,
    from ``net/websocket.serve_ws`` without a ``post`` route)."""
    from asciichat_tpu.net.websocket import connect_ws

    port, ws_port = _free_port(), _free_port()
    proc = _start_server(port, "--ws-port", str(ws_port), block=NO_CRYPTO)
    frame = synthetic_frame(48, 64, seed=25)
    plan = compositor.plan_composite([(64, 48)], TERM_W, TERM_H)
    want = oracle.ascii_convert_with_capabilities(
        compositor.composite_reference(frame[None], plan), TERM_W, 2 * TERM_H, HB_TRUECOLOR)

    async def drive():
        _wait_listening(proc, ws_port)
        status, page = await _http(ws_port, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        assert status == b"HTTP/1.1 200 OK" and b"<html" in page.lower()
        for path in ("/webrtc/offer", "/webrtc/candidate?ufrag=x"):
            status, _ = await _http(ws_port, f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                                             "Content-Length: 4\r\n\r\nv=0\n".encode())
            assert status == b"HTTP/1.1 400 Bad Request", path
        t = await connect_ws("127.0.0.1", ws_port)
        try:
            wire = proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                          capabilities_mask=0x1)
            await t.send(pkt.PacketType.CLIENT_CAPABILITIES, wire.pack())
            await t.send(pkt.PacketType.IMAGE_FRAME,
                         pkt.pack_image_frame(frame.tobytes(), frame.shape[1], frame.shape[0]))
            while True:
                ptype, payload = await asyncio.wait_for(t.recv(), WAIT_S)
                if (ptype == pkt.PacketType.ASCII_FRAME
                        and pkt.unpack_ascii_frame(payload)[0] == want):
                    return
        finally:
            await t.close()

    try:
        asyncio.run(asyncio.wait_for(drive(), 2 * WAIT_S))
        assert proc.poll() is None, "the server exited"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        err = proc.stderr.read().decode(errors="replace")
        proc.stderr.close()
    assert "Traceback" not in err, err[-3000:]


def test_client_webrtc_without_cryptography_says_so():
    """``client --webrtc`` with ``cryptography`` blocked exits 1 with one
    line on stderr that names the package, and no traceback."""
    code = NO_CRYPTO + ("from asciichat_tpu_torch.apps.main import main\n"
                        "sys.exit(main(['client', '127.0.0.1', '--port', '1', '--webrtc', "
                        "'--test-pattern', '--log-level', 'WARNING']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=WAIT_S)
    assert out.returncode == 1, out.stderr[-3000:]
    assert out.stderr.count("\n") == 1 and "`cryptography`" in out.stderr, out.stderr
    assert out.stdout == ""


# -- the rest of the CLI, and the forced mesh -------------------------------------


def test_completions_without_the_jax_package():
    from asciichat_tpu.utils import options as jopt

    code = BLOCK + ("from asciichat_tpu_torch.apps.main import main\n"
                    "sys.exit(main(['completions', 'bash']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout == jopt.generate_completions(jopt.default_registry(), "bash") + "\n"


def test_forced_mesh_server_and_query_without_the_jax_package():
    """``server`` under ``ASCIICHAT_FORCE_MESH=4`` and
    ``ASCIICHAT_MESH_SPACE=2`` on the CPU serves an oracle frame, its
    inspector shows the (2, 2) grid and no stack copy, and ``query PID``
    prints its Python stacks: the server, and ``query``, with
    ``asciichat_tpu`` blocked."""
    import json
    import urllib.request

    from test_torch_cli import query_report
    from test_torch_mesh import serve_one_oracle_frame

    port, insp = _free_port(), _free_port()
    code = BLOCK + (
        "import os\n"
        "os.environ.update(ASCIICHAT_FORCE_MESH='4', ASCIICHAT_MESH_SPACE='2')\n"
        "from asciichat_tpu_torch.apps.main import main\n"
        f"sys.exit(main(['server', '--host', '127.0.0.1', '--port', '{port}', "
        f"'--inspect-port', '{insp}', '--log-level', 'WARNING']))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        _wait_listening(proc, port)
        serve_one_oracle_frame(port, synthetic_frame(48, 64, seed=26))
        _wait_listening(proc, insp)
        with urllib.request.urlopen(f"http://127.0.0.1:{insp}/state/server", timeout=30) as r:
            state = json.loads(r.read())
        assert state["mesh"] == {"clients": 2, "space": 2}, state
        assert state["mesh_collectives"] == 0 and state["device"] == "cpu", state
        report = query_report(proc.pid)
        assert "Thread" in report["pystacks"] and "File " in report["pystacks"], \
            report["pystacks"][:800]
        assert proc.poll() is None, "query stopped the server"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        err = proc.stderr.read().decode(errors="replace")
        proc.stderr.close()
    assert "Traceback" not in err, err[-3000:]
