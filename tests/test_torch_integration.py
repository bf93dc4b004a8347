"""The port's command line end to end: ``python -m asciichat_tpu_torch.apps.main``
servers and clients as processes on the CPU (``ASCIICHAT_TORCH_DEVICE=cpu``),
held to the cases of the JAX package's tests/test_integration.py that no
other port test covers, written anew for the port.

Each case takes its ports from ``bind(0)``, starts its own server and waits
until it accepts (no fixed sleep), bounds every wait by LIMIT seconds and
kills every process it started in a ``finally``. A server's and a client's
stderr go to files under the case's tmp_path (a full pipe would stall
them); HOME and TMPDIR point there too. Codec cases skip as the JAX cases
do, with the reason: no libopus, no H.265 encoder.

Here: protocol fuzz and connection churn, render-group churn under load, a
0x0 frame and the sweep of a silent client, a custom palette and colour
filter over the wire, the H.265 uplink with the real codec, SSH key
authentication, and the live server's batched tick as the inspector reports
it. The audio cases are in test_torch_integration_audio.py."""

import asyncio
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import protocol as proto
from asciichat_tpu_torch.net.transport import connect_tcp
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime import codecs

REPO = Path(__file__).resolve().parent.parent
LIMIT = 60.0  # seconds for any one wait here
P = pkt.PacketType


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def until(cond, what: str, limit: float = LIMIT, procs: tuple = ()) -> None:
    """Poll ``cond()`` until it is true; fail at the deadline, or as soon as
    one of ``procs`` (``Child``) has exited."""
    end = time.monotonic() + limit
    while not cond():
        for p in procs:
            if p.proc.poll() is not None:
                raise AssertionError(f"{p.name} exited {p.proc.returncode} before {what}: "
                                     f"{p.err()[-3000:]}")
        if time.monotonic() > end:
            raise AssertionError(f"timed out after {limit:.0f} s waiting for {what}")
        time.sleep(0.05)


class Child:
    """``python -m asciichat_tpu_torch.apps.main ARGS`` on the CPU. Its
    stdout is a pipe (left unread unless the case reads it) or /dev/null;
    its stderr goes to ``<tmp>/<name>.err``."""

    def __init__(self, tmp: Path, name: str, *args: str, stdout=subprocess.PIPE,
                 env: dict | None = None):
        self.name = name
        self.err_path = tmp / f"{name}.err"
        env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", PYTHONPATH=str(REPO),
                   HOME=str(tmp), TMPDIR=str(tmp), OMP_NUM_THREADS="1", **(env or {}))
        with open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "asciichat_tpu_torch.apps.main", *args],
                cwd=REPO, env=env, stdout=stdout, stderr=err)

    def err(self) -> str:
        return self.err_path.read_text(errors="replace")

    def communicate(self, limit: float = LIMIT) -> tuple[int, bytes]:
        out, _ = self.proc.communicate(timeout=limit)
        return self.proc.returncode, out or b""


    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=LIMIT)
        if self.proc.stdout:
            self.proc.stdout.close()


def interrupt(*children: Child) -> None:
    """SIGINT to each, as a user's Ctrl-C; each that has not exited within
    LIMIT is killed."""
    for c in children:
        if c.proc.poll() is None:
            c.proc.send_signal(signal.SIGINT)
    for c in children:
        try:
            c.proc.wait(timeout=LIMIT)
        except subprocess.TimeoutExpired:
            c.proc.kill()


def accepts(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
        return True
    except OSError:
        return False


def start_server(tmp: Path, *extra: str, env: dict | None = None,
                 log_level: str = "WARNING") -> tuple[Child, int]:
    """A server on a free port, once it accepts connections."""
    port = free_port()
    srv = Child(tmp, "server", "server", "--port", str(port), "--log-level", log_level, *extra,
                stdout=subprocess.DEVNULL, env=env)
    until(lambda: accepts(port), "the server to accept", procs=(srv,))
    return srv, port


def client(tmp: Path, name: str, port: int, *extra: str, stdout=subprocess.PIPE) -> Child:
    return Child(tmp, name, "client", "127.0.0.1", "--port", str(port), "--no-reconnect",
                 *extra, stdout=stdout)


def run_async(coro, limit: float = 2 * LIMIT):
    return asyncio.run(asyncio.wait_for(coro, limit))


def test_server_survives_protocol_fuzz_and_churn(tmp_path):
    """Random garbage, malformed packets of every type, truncated
    handshakes and connect/disconnect churn do not kill the server, and a
    well-behaved client gets frames afterwards."""
    srv, port = start_server(tmp_path, log_level="ERROR")
    procs = [srv]
    try:
        async def fuzz():
            rng = random.Random(1234)
            for _ in range(10):  # raw garbage streams
                _r, w = await asyncio.open_connection("127.0.0.1", port)
                w.write(rng.randbytes(rng.randint(1, 4096)))
                try:
                    await w.drain()
                    w.close()
                    await w.wait_closed()
                except (ConnectionError, OSError):
                    pass
            # valid headers, malformed payloads, for every packet type
            for ptype in (1, 1000, 1100, 1102, 2000, 2002, 3000, 3001, 3002,
                          4000, 4001, 5000, 5001, 5005, 6000, 6051):
                try:
                    t = await connect_tcp("127.0.0.1", port)
                    for _ in range(3):
                        await t.send(ptype, rng.randbytes(rng.randint(0, 512)))
                    await t.close()
                except (ConnectionError, OSError, ValueError):
                    pass
            for _ in range(5):  # truncated handshakes
                try:
                    t = await connect_tcp("127.0.0.1", port)
                    await t.send(P.CRYPTO_CAPABILITIES, b"\x01")
                    await t.close()
                except (ConnectionError, OSError):
                    pass
            for _ in range(20):  # churn with capabilities and an Opus batch
                try:
                    t = await connect_tcp("127.0.0.1", port)
                    await t.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities().pack())
                    await t.send(P.AUDIO_OPUS_BATCH,
                                 pkt.pack_audio_batch(rng.randbytes(40), 480, 1))
                    await t.close()
                except (ConnectionError, OSError):
                    pass

        run_async(fuzz())
        until(lambda: accepts(port), "the server to accept after the fuzz", procs=(srv,))
        ok = client(tmp_path, "client", port, "--test-pattern", "--width", "40",
                    "--height", "10", "--color-mode", "NONE", "--max-frames", "3",
                    "--log-level", "WARNING")
        procs.append(ok)
        rc, out = ok.communicate()
        assert rc == 0, ok.err()[-2000:]
        assert len(out) > 100
        assert srv.proc.poll() is None, "the server died under the fuzz"
    finally:
        for p in procs:
            p.kill()


def test_render_group_churn_under_load(tmp_path):
    """While an uploader streams and a viewer watches, a churner re-sends
    CLIENT_CAPABILITIES 40 times through geometry x render mode x colour
    level x filter x palette (each a new render group). Frames keep
    reaching both receivers, the churner's geometries are honoured, and the
    server lives."""
    srv, port = start_server(tmp_path, log_level="ERROR")
    try:
        async def run():
            up = await connect_tcp("127.0.0.1", port)
            await up.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities().pack())
            frame = np.zeros((60, 80, 3), np.uint8)
            frame[:, :40] = [220, 40, 90]

            async def uploader():
                while True:
                    await up.send(P.IMAGE_FRAME, pkt.pack_image_frame(frame.tobytes(), 80, 60))
                    await asyncio.sleep(0.05)

            viewer = await connect_tcp("127.0.0.1", port)
            await viewer.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities(
                caps=TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
                width=64, height=20).pack())
            viewer_frames = 0

            async def watch():
                nonlocal viewer_frames
                while True:
                    ptype, _ = await viewer.recv()
                    viewer_frames += ptype == P.ASCII_FRAME

            churner = await connect_tcp("127.0.0.1", port)
            widths = set()
            pool = [(40, 12, ColorLevel.NONE, RenderMode.FOREGROUND, 0, ""),
                    (60, 20, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, 3, ""),
                    (30, 10, ColorLevel.COLOR_256, RenderMode.FOREGROUND, 8, "   .-+*#"),
                    (50, 16, ColorLevel.COLOR_16, RenderMode.HALF_BLOCK, 12, ""),
                    (45, 14, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, 6, "")]

            async def churn():
                for i in range(40):
                    w, h, level, mode, filt, palette = pool[i % len(pool)]
                    await churner.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities(
                        caps=TerminalCapabilities(level, mode), width=w, height=h,
                        color_filter=filt, palette_custom=palette).pack())
                    end = asyncio.get_running_loop().time() + 3
                    while asyncio.get_running_loop().time() < end:  # a frame at the new settings
                        ptype, payload = await asyncio.wait_for(churner.recv(), 5)
                        if ptype == P.ASCII_FRAME:
                            widths.add(pkt.ASCII_FRAME_HDR.unpack(payload[:24])[0])
                            break

            tasks = [asyncio.create_task(uploader()), asyncio.create_task(watch())]
            try:
                await asyncio.wait_for(churn(), 90)
                assert viewer_frames > 20, viewer_frames  # through 40 re-negotiations
                assert len(widths) >= 3, widths  # the geometry changes were honoured
            finally:
                for task in tasks:
                    task.cancel()
                for t in (up, viewer, churner):
                    await t.close()

        run_async(run())
        assert srv.proc.poll() is None, "the server died under render-group churn"
    finally:
        srv.kill()


def test_zero_dim_frame_rejected_and_zombies_swept(tmp_path):
    """A 0x0 IMAGE_FRAME gets its sender disconnected and the video tick
    goes on for everyone else; a client that goes silent is PING-probed
    and then swept (ASCIICHAT_CLIENT_TIMEOUT=6), while a pinging one lives."""
    srv, port = start_server(tmp_path, env={"ASCIICHAT_CLIENT_TIMEOUT": "6"})
    try:
        async def run():
            evil = await connect_tcp("127.0.0.1", port)
            await evil.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities().pack())
            await evil.send(P.IMAGE_FRAME, pkt.pack_image_frame(b"", 0, 0))
            with pytest.raises((asyncio.IncompleteReadError, ConnectionError,
                                asyncio.TimeoutError, ValueError)):
                for _ in range(200):  # the server must drop us
                    await asyncio.wait_for(evil.recv(), 10)

            good = await connect_tcp("127.0.0.1", port)
            await good.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities().pack())
            frame = np.full((24, 32, 3), 180, np.uint8)
            await good.send(P.IMAGE_FRAME, pkt.pack_image_frame(frame.tobytes(), 32, 24))
            end = asyncio.get_running_loop().time() + 20
            got_frame = False
            while not got_frame and asyncio.get_running_loop().time() < end:
                ptype, _ = await asyncio.wait_for(good.recv(), 10)
                got_frame = ptype == P.ASCII_FRAME
            assert got_frame, "video tick dead after the 0x0 frame"

            zombie = await connect_tcp("127.0.0.1", port)
            await zombie.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities().pack())

            async def keep_pinging():
                for _ in range(30):
                    good.send_nowait(P.PING, b"alive")
                    await asyncio.sleep(1.0)

            pinger = asyncio.create_task(keep_pinging())
            probed = dropped = False
            end = asyncio.get_running_loop().time() + 25
            try:
                while asyncio.get_running_loop().time() < end:
                    ptype, _ = await asyncio.wait_for(zombie.recv(), 20)
                    probed |= ptype == P.PING  # and deliberately not answered
            except (asyncio.IncompleteReadError, ConnectionError, asyncio.TimeoutError):
                dropped = True
            assert probed, "the server never probed the silent client"
            assert dropped, "the silent client was never swept"
            await asyncio.wait_for(good.recv(), 10)  # the pinging client is still served
            pinger.cancel()
            await good.close()

        run_async(run())
        assert srv.proc.poll() is None
    finally:
        srv.kill()


def test_custom_palette_and_filter_over_wire(tmp_path):
    """CLIENT_CAPABILITIES' palette_custom and color_filter personalise the
    frames: a mono render of a flat bright source with palette "@+. " uses
    only that palette's characters."""
    srv, port = start_server(tmp_path)
    try:
        async def run():
            feeder = await connect_tcp("127.0.0.1", port)
            await feeder.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities().pack())
            frame = np.full((48, 64, 3), 200, np.uint8)
            viewer = await connect_tcp("127.0.0.1", port)
            await viewer.send(P.CLIENT_CAPABILITIES, proto.WireCapabilities(
                caps=TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND,
                                          wants_padding=False),
                width=40, height=12, palette_custom="@+. ", color_filter=3).pack())
            end = asyncio.get_running_loop().time() + 30
            body = None
            while body is None and asyncio.get_running_loop().time() < end:
                # keep feeding, so that the tick has a source
                await feeder.send(P.IMAGE_FRAME, pkt.pack_image_frame(frame.tobytes(), 64, 48))
                try:
                    ptype, payload = await asyncio.wait_for(viewer.recv(), 5)
                except asyncio.TimeoutError:
                    continue
                if ptype == P.ASCII_FRAME:
                    body = pkt.unpack_ascii_frame(payload)[0]
            await feeder.close()
            await viewer.close()
            return body

        body = run_async(run())
        assert body is not None, "no frame within 30 s"
        visible = set(body.replace(b"\n", b"")) - set(b"\x1b[0123456789b")
        assert visible and visible <= set(b"@+. "), visible
    finally:
        srv.kill()


def test_h265_uplink_end_to_end_real_codec(tmp_path):
    """client --h265 learns from SERVER_STATE that the server decodes
    H.265, encodes with the native libavcodec shim, and the server's
    per-client decoder feeds the render: ASCII frames come back."""
    try:
        codecs.H265Encoder(64, 48).close()
    except codecs.CodecUnavailable:
        pytest.skip("no H.265 codec available")
    srv, port = start_server(tmp_path)
    procs = [srv]
    try:
        c = client(tmp_path, "client", port, "--test-pattern", "--h265", "--width", "40",
                   "--height", "12", "--color-mode", "TRUECOLOR", "--max-frames", "8",
                   "--log-level", "INFO")
        procs.append(c)
        rc, out = c.communicate()
        err = c.err()
        assert rc == 0, err[-2000:]
        assert "server supports h265" in err  # the negotiation happened
        assert b"\x1b[" in out  # frames rendered from decoded H.265 uploads
        assert srv.proc.poll() is None
    finally:
        for p in procs:
            p.kill()


def test_ssh_key_auth_end_to_end(tmp_path):
    """server --allowed-keys and client --ssh-key as processes: the listed
    key gets frames over the encrypted session, an unlisted one is
    refused, and the server lives."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat, PublicFormat,
    )

    good, evil = Ed25519PrivateKey.generate(), Ed25519PrivateKey.generate()
    (tmp_path / "authorized_keys").write_text(
        good.public_key().public_bytes(Encoding.OpenSSH, PublicFormat.OpenSSH).decode()
        + " tester\n")
    for name, key in (("good", good), ("evil", evil)):
        (tmp_path / name).write_bytes(key.private_bytes(
            Encoding.PEM, PrivateFormat.OpenSSH, NoEncryption()))
    srv, port = start_server(tmp_path, "--allowed-keys", str(tmp_path / "authorized_keys"))
    procs = [srv]
    try:
        ok = client(tmp_path, "good", port, "--test-pattern", "--ssh-key",
                    str(tmp_path / "good"), "--width", "40", "--height", "10",
                    "--color-mode", "NONE", "--max-frames", "3", "--log-level", "INFO")
        procs.append(ok)
        rc, out = ok.communicate()
        assert rc == 0, ok.err()[-2000:]
        assert "encryption established" in ok.err()
        assert len(out) > 100  # frames arrived

        bad = client(tmp_path, "evil", port, "--test-pattern", "--ssh-key",
                     str(tmp_path / "evil"), "--max-frames", "2", "--log-level", "WARNING")
        procs.append(bad)
        rc, out = bad.communicate()
        assert rc != 0 or b"\x1b[" not in out
        assert srv.proc.poll() is None  # the server survives the failed auth
    finally:
        for p in procs:
            p.kill()


def test_live_server_uses_batched_device_tick(tmp_path):
    """The port's test_live_server_uses_batched_device_tick: the live
    server renders through its batched tick (models/server.tick_compute),
    as the inspector's /state/server reports: tick_compute > 0, and on the
    CPU the plain render, so no K3 launch (render_launches 0, device
    "cpu"). The port has no host render path and so no ``device_tick`` key
    (ROADMAP.md, deliberate differences)."""
    insp = free_port()
    srv, port = start_server(tmp_path, "--inspect-port", str(insp))
    procs = [srv]
    try:
        c = client(tmp_path, "client", port, "--test-pattern", "--width", "40",
                   "--height", "12", "--color-mode", "TRUECOLOR", "--max-frames", "5",
                   "--log-level", "WARNING")
        procs.append(c)
        rc, out = c.communicate()
        assert rc == 0, c.err()[-2000:]
        assert b"\x1b[" in out  # truecolor frames arrived
        until(lambda: accepts(insp), "the inspector to accept", procs=(srv,))
        with urllib.request.urlopen(f"http://127.0.0.1:{insp}/state/server",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["tick_compute"] > 0, stats
        assert stats["device"] == "cpu" and stats["render_launches"] == 0, stats
        assert stats["device_failures"] == 0, stats
        assert "device_tick" not in stats
    finally:
        for p in procs:
            p.kill()
