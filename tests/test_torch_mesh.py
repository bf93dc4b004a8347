"""Multi-device serving on the port, on the CPU: ``parallel/mesh.py`` (the
mesh, the shard plan) and the sharded render of ``models/server.py``
(``RenderGroup(mesh=)``, ``render_groups``, ``MeshArena``), every shard on
``cpu``.

The port of ``__graft_entry__.dryrun_multichip`` and of
``tests/test_server_mesh.py``: a sharded ``render_groups`` over 1-D meshes
of 2, 4 and 8 shards and 2-D meshes of (4, 2) and (8, 2) gives records equal
to the unsharded render and to the JAX package's own mesh render on the 8
virtual CPU devices that ``tests/conftest.py`` provides (for (8, 2), which
needs 16, JAX's (4, 2): its mesh renders are value-exact with one another),
with a single receiver on 8 shards, odd half-block heights (where the JAX
package's own render at the same geometry is the reference), rainbow, and
two geometry groups in one call. The live server's ``_render_tick`` under a
forced mesh sends frames byte-identical to the unsharded tick and to the JAX
server's sharded tick, and the server as a process under
``ASCIICHAT_FORCE_MESH=8`` (and ``ASCIICHAT_MESH_SPACE=2``) serves oracle
frames and reports its mesh on the inspector. K3's source with the row-shard
descriptors runs under ``tests/cuda_emu.h`` in
``tests/test_torch_render_group_emulated.py``. Tolerance: exact (uint8
records, bytes)."""

import asyncio
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from asciichat_tpu.apps import server as jserver
from asciichat_tpu.models import server as jmodel
from asciichat_tpu.net import packet as jpkt
from asciichat_tpu.net import protocol as jproto
from asciichat_tpu.net.transport import connect_tcp
from asciichat_tpu.ops import cells as jcells
from asciichat_tpu.ops import compositor as jcompositor
from asciichat_tpu.parallel import mesh as jmesh
from asciichat_tpu.render import oracle
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.models import server as tmodel
from asciichat_tpu_torch.net import protocol as tproto
from asciichat_tpu_torch.ops import filters as tfilters
from asciichat_tpu_torch.parallel import mesh as tmesh
from asciichat_tpu_torch.render import pipeline as tpipeline

from conftest import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
HB = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
FG256 = TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND)
HB16 = TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.HALF_BLOCK)
SIZES = [(32, 24), (48, 36), (40, 30)]
TIME_S = 1.3  # the rainbow's hue

# name -> (clients, space): the number of shards is their product
MESHES = {"2": (2, 1), "4": (4, 1), "8": (8, 1), "4x2": (4, 2), "8x2": (8, 2)}
# name -> groups of one render: (term_w, term_h, caps, receivers' filters)
CASES = {
    "mixed": [(40, 11, HB, ["none", "green", "rainbow", "cyan", "none"])],
    "two_groups": [(41, 13, HB16, ["rainbow", "pink", "white"]),
                   (30, 9, FG256, ["none", "green", "teal", "rainbow", "red", "black"])],
    "single": [(36, 10, HB, ["green"])],
}


def _stack(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (len(SIZES), 36, 48, 3), dtype=np.uint8)


def _cpu_mesh(name: str) -> tmesh.Mesh:
    clients, space = MESHES[name]
    return tmesh.make_mesh(clients * space, space, [CPU] * (clients * space))


def _port_render(stack: np.ndarray, spec, mesh) -> list[dict[str, np.ndarray]]:
    groups = [tmodel.RenderGroup(SIZES, w, h, caps, names, device=CPU, mesh=mesh)
              for w, h, caps, names in spec]
    arena = tmodel.MeshArena(mesh) if mesh is not None else tmodel.RecordArena(CPU)
    return arena.fetch(tmodel.render_groups(torch.from_numpy(stack), groups, TIME_S, arena))


_JAX_RENDERS: dict = {}


def _jax_mesh_render(stack: np.ndarray, spec, mesh_name: str) -> list[dict[str, np.ndarray]]:
    """The JAX package's RenderGroup on its mesh over the virtual CPU
    devices, the padded receivers sliced off (as its server does)."""
    clients, space = MESHES[mesh_name]
    if clients * space > len(jax.devices("cpu")):
        clients = len(jax.devices("cpu")) // space
    key = (id(spec), clients, space, stack.tobytes())
    if key not in _JAX_RENDERS:
        mesh = jmesh.make_mesh(clients * space, space=space, devices=jax.devices("cpu"))
        padded = np.zeros((len(SIZES) + (-len(SIZES) % clients), *stack.shape[1:]), np.uint8)
        padded[:len(SIZES)] = stack
        frames = jax.device_put(padded, jmesh.client_sharding(mesh))
        out = []
        for w, h, caps, names in spec:
            grp = jmodel.RenderGroup(SIZES, w, h, caps, names, mesh=mesh)
            rec = jcells.records_to_numpy(grp.step(frames, TIME_S))
            out.append({k: v[:grp.n_real] for k, v in rec.items()})
        _JAX_RENDERS[key] = out
    return _JAX_RENDERS[key]


def _assert_records_equal(got, want, what: str) -> None:
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), f"{what}, group {i}"
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=f"{what}, group {i}, {k}")


# -- the mesh and the shard plan ----------------------------------------------


def test_make_mesh_shapes_and_devices():
    m = tmesh.make_mesh(8, space=2, devices=[CPU] * 8)
    assert m.shape == {"clients": 4, "space": 2} and m.device_list() == [CPU]
    assert tmesh.make_mesh(4, devices=[CPU] * 4).shape == {"clients": 4}
    cards = [torch.device("cuda", i) for i in range(4)]
    assert tmesh.make_mesh(devices=cards).device_list() == cards
    with pytest.raises(ValueError):
        tmesh.make_mesh(6, space=4, devices=[CPU] * 6)
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, devices=[CPU] * 2)


@pytest.mark.parametrize("n, parts", [(9, 4), (3, 8), (0, 2), (64, 2), (5, 1), (12, 4)])
def test_split_is_the_xla_layout(n, parts):
    """Contiguous chunks of ceil(n / parts), as the JAX package's padded
    sharding places them; together they cover [0, n) once."""
    ranges = tmesh.split(n, parts)
    assert len(ranges) == parts
    assert [i for r in ranges for i in r] == list(range(n))
    step = -(-n // parts)
    assert all(r.start == min(i * step, n) for i, r in enumerate(ranges))


def test_shard_plan_covers_receivers_and_rows():
    m = tmesh.make_mesh(8, space=2, devices=[CPU] * 8)
    plan = tmesh.shard_plan(m, 5, 13)
    assert [s.index for s in plan] == list(range(8))
    cells = {(c, r) for s in plan for c in s.receivers for r in s.rows}
    assert len(cells) == sum(len(s.receivers) * len(s.rows) for s in plan) == 5 * 13
    assert plan[0].rows == range(0, 7) and plan[1].rows == range(7, 13)
    assert plan[6].receivers == range(5, 5)  # ceil(5 / 4) = 2: the last shard is empty


@pytest.mark.parametrize("family", [0, 4])  # mono, half-block truecolor
@pytest.mark.parametrize("hpx", [1, 2, 7, 22, 23])
def test_pixel_rows_split_half_block_at_even_rows(family, hpx):
    half = family in tmodel.cells.HALFBLOCK_FAMILIES
    rows = tmodel.cell_rows(family, hpx)
    spans = [tmodel.pixel_rows(family, hpx, r) for r in tmesh.split(rows, 3) if r]
    assert spans[0][0] == 0 and spans[-1][1] == hpx
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if half:
        assert all(y0 % 2 == 0 for y0, _ in spans)
        assert all((y1 - y0) % 2 == 0 for y0, y1 in spans[:-1] if y1 < hpx)


def test_replicate_copies_to_each_other_device():
    x = torch.arange(12, dtype=torch.uint8)
    one = tmesh.replicate(x, tmesh.make_mesh(4, devices=[CPU] * 4))
    assert list(one) == [CPU] and one[CPU] is x


def test_serving_mesh_space_axis_env(monkeypatch):
    """tests/test_server_mesh.py:313 on the port: ASCIICHAT_MESH_SPACE builds
    the 2-D mesh; a non-dividing extent stays 1-D. The forced mesh is on the
    server's device, the card by default, and never on another one."""
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ASCIICHAT_FORCE_MESH", "8")
    monkeypatch.setenv("ASCIICHAT_MESH_SPACE", "2")
    m = tmesh.serving_mesh()
    assert m.shape == {"clients": 4, "space": 2} and m.device_list() == [CPU]
    monkeypatch.setenv("ASCIICHAT_MESH_SPACE", "3")  # 8 % 3 != 0
    assert tmesh.serving_mesh().shape == {"clients": 8}
    monkeypatch.setenv("ASCIICHAT_MESH_SPACE", "")
    assert tmesh.serving_mesh().shape == {"clients": 8}
    card = torch.device("cuda", 0)
    assert tmesh.serving_mesh(card).device_list() == [card]  # no CPU implied
    monkeypatch.setenv("ASCIICHAT_FORCE_MESH", "1")
    assert tmesh.serving_mesh() is None
    monkeypatch.delenv("ASCIICHAT_FORCE_MESH")
    assert tmesh.serving_mesh() is None  # the CPU is never auto-meshed


def test_server_start_does_not_serve_around_a_mesh_failure(monkeypatch):
    """A mesh that was asked for and cannot be built stops the start."""
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")

    def broken(device=None):
        raise RuntimeError("no such mesh")

    monkeypatch.setattr(tmesh, "serving_mesh", broken)
    with pytest.raises(RuntimeError, match="no such mesh"):
        tserver.AsciiChatServer()


def test_serving_mesh_over_every_visible_card(monkeypatch):
    """Without ASCIICHAT_FORCE_MESH, a server on a card meshes over every
    visible card when there is more than one (the JAX package's rule), 2-D
    under ASCIICHAT_MESH_SPACE; one card, or the CPU, serves unsharded."""
    monkeypatch.delenv("ASCIICHAT_FORCE_MESH", raising=False)
    monkeypatch.delenv("ASCIICHAT_MESH_SPACE", raising=False)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = tmesh.serving_mesh(card)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert m.shape == {"clients": 4} and m.device_list() == cards
    monkeypatch.setenv("ASCIICHAT_MESH_SPACE", "2")
    assert tmesh.serving_mesh(card).shape == {"clients": 2, "space": 2}
    assert tmesh.serving_mesh(CPU) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.serving_mesh(card) is None


# -- the sharded render against the single render and the JAX package's -------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_render_groups_match(case, mesh_name):
    """dryrun_multichip on the port: every shape of mesh, value-exact with
    the unsharded render and with the JAX package's mesh render."""
    stack = _stack()
    spec = CASES[case]
    got = _port_render(stack, spec, _cpu_mesh(mesh_name))
    _assert_records_equal(got, _port_render(stack, spec, None), f"{case} on {mesh_name} vs single")
    _assert_records_equal(got, _jax_mesh_render(stack, spec, mesh_name),
                          f"{case} on {mesh_name} vs the JAX mesh")


@pytest.mark.parametrize("mesh_name", ["2", "8", "4x2", "8x2"])
@pytest.mark.parametrize("mode, hpx", [("halfblock_truecolor", 23), ("halfblock_256", 9),
                                       ("halfblock_16", 1), ("truecolor_fg", 13)])
def test_sharded_odd_heights_match_the_jax_render(mode, hpx, mesh_name):
    """Odd pixel heights: the last row shard of a half-block render holds
    an odd count of pixel rows (its bottom row repeats its top). The JAX
    package's render_compute at the same geometry is the reference."""
    plan = tmodel.plan_tick(SIZES, 31, 12, HB)
    plan = dataclasses.replace(plan, render=tpipeline.RenderPlan(mode, 31, hpx, 0, 0))
    names = ["none", "rainbow", "cyan"]
    stack = _stack(3)
    single = tmodel.RenderGroup.from_plan(plan, names, device=CPU)
    grp = tmodel.RenderGroup.from_plan(plan, names, device=CPU, mesh=_cpu_mesh(mesh_name))
    got = grp.fetch(grp.step(torch.from_numpy(stack), TIME_S))
    want = single.fetch(single.step(torch.from_numpy(stack), TIME_S))
    params = tfilters.filter_params(names, TIME_S)
    jwant = jcells.records_to_numpy(jmodel._render_step(
        stack, np.asarray(single.ramp), *params,
        *jcompositor.host_maps(jcompositor.plan_composite(SIZES, 31, 12)),
        mode=mode, dst_h=hpx, dst_w=31))
    _assert_records_equal([got, got], [want, jwant], f"{mode} hpx {hpx} on {mesh_name}")


def test_single_receiver_on_8_shards():
    """tests/test_server_mesh.py:109 on the port: one receiver on 8 shards
    needs no padding. Only the first shard has a part (the others render
    nothing), and the records equal the unsharded and the JAX package's
    padded render's first row."""
    spec = CASES["single"]
    grp = tmodel.RenderGroup(SIZES, *spec[0][:4], device=CPU, mesh=_cpu_mesh("8"))
    assert [shard.index for shard, _ in grp.shard_jobs] == [0]
    assert grp.n_real == 1
    stack = _stack(1)
    got = [grp.fetch(grp.step(torch.from_numpy(stack), TIME_S))]
    _assert_records_equal(got, _port_render(stack, spec, None), "vs single")
    _assert_records_equal(got, _jax_mesh_render(stack, spec, "8"), "vs the JAX mesh")


def test_rainbow_tint_reaches_every_shard():
    """The rainbow tint moves every tick; each shard's job holds views of
    the group's receivers, so every tick of the sharded render equals the
    unsharded one at that time."""
    names = ["rainbow", "none", "rainbow", "green", "rainbow"]
    mesh = _cpu_mesh("4x2")
    grp = tmodel.RenderGroup(SIZES, 40, 11, HB, names, device=CPU, mesh=mesh)
    single = tmodel.RenderGroup(SIZES, 40, 11, HB, names, device=CPU)
    frames = torch.from_numpy(_stack(2))
    for t in (0.0, 0.9, 2.2):
        got = grp.fetch(grp.step(frames, t))
        _assert_records_equal([got], [single.fetch(single.step(frames, t))], f"t={t}")
        tint = tfilters.rainbow_color(t)
        assert all(tuple(job.receivers[0, :3]) == tint for _, job in grp.shard_jobs)


# ``cpu`` and ``cpu:0`` are distinct devices to the mesh: in place of several
# cards, they drive the path where the stack is copied to another device
CPU0 = torch.device("cpu", 0)
DISTINCT = {"2": (2, 1), "2x2": (2, 2)}  # name -> (clients, space), the devices in turn


def _distinct_mesh(name: str) -> tmesh.Mesh:
    clients, space = DISTINCT[name]
    return tmesh.make_mesh(clients * space, space, [CPU, CPU0] * clients * space)


@pytest.mark.parametrize("mesh_name", list(DISTINCT))
def test_sharded_render_on_distinct_devices(mesh_name):
    """A mesh whose shards lie on two devices: one copy of the stack a
    render, and records equal to the unsharded render's."""
    mesh = _distinct_mesh(mesh_name)
    stack = _stack(4)
    spec = CASES["two_groups"]
    groups = [tmodel.RenderGroup(SIZES, w, h, caps, names, device=CPU, mesh=mesh)
              for w, h, caps, names in spec]
    arena = tmodel.MeshArena(mesh)
    assert list(arena.arenas) == [CPU, CPU0]
    records = tmodel.render_groups(torch.from_numpy(stack), groups, TIME_S, arena)
    assert arena.copies == 1
    assert {shard.device for part in records for shard, _ in part.parts} == {CPU, CPU0}
    _assert_records_equal(arena.fetch(records), _port_render(stack, spec, None),
                          f"{mesh_name} on two devices vs single")


# -- the live server's tick under a mesh ----------------------------------------


class FakeTransport:
    """Captures server->client sends; enough surface for the render tick."""

    def __init__(self):
        self.sent: list[tuple[int, bytes]] = []
        self.peername = ("127.0.0.1", 0)

    def send_nowait(self, ptype, payload: bytes = b"", **kw) -> bool:
        self.sent.append((int(ptype), bytes(payload)))
        return True


SPECS = [("none", 60, 20), ("green", 60, 20), ("none", 60, 20), ("cyan", 44, 16)]


def _clients(server_mod, proto_mod):
    clients = []
    for i, (name, w, h) in enumerate(SPECS):
        c = server_mod.ClientState(i + 1, FakeTransport())
        c.wire_caps = proto_mod.WireCapabilities(width=w, height=h)
        c.has_caps = True
        c.filter_name = name
        c.video.commit(synthetic_frame(48, 64, seed=i))
        c.streaming = True
        clients.append(c)
    return clients


def _sent(clients) -> list[list[bytes]]:
    return [[p for t, p in c.transport.sent if t == int(jpkt.PacketType.ASCII_FRAME)]
            for c in clients]


def _port_tick(monkeypatch, force: str, space: str = "") -> tuple[list, object]:
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ASCIICHAT_FORCE_MESH", force)
    monkeypatch.setenv("ASCIICHAT_MESH_SPACE", space)
    srv = tserver.AsciiChatServer()
    clients = _clients(tserver, tproto)
    srv._render_tick(clients)
    assert srv.device_failures == 0
    return _sent(clients), srv


@pytest.mark.parametrize("space", ["", "2"], ids=["1d", "2d"])
def test_live_render_tick_mesh_byte_identical(space, monkeypatch):
    """tests/test_server_mesh.py:72 and :281 on the port: the server's
    _render_tick under an 8-shard mesh (1-D, and 4 x 2) sends what the
    unsharded tick sends and what the JAX server's sharded tick sends, byte
    for byte, across two geometry groups, mixed filters and a shared one.
    Every shard is on the CPU: no stack copy between devices."""
    single, _ = _port_tick(monkeypatch, "")
    sharded, srv = _port_tick(monkeypatch, "8", space)
    want_shape = {"clients": 8} if not space else {"clients": 4, "space": 2}
    assert srv.mesh.shape == want_shape
    assert srv.server_state()["mesh"] == want_shape
    assert srv.mesh_collectives == 0
    groups = list(srv._group_cache.values())
    assert groups and all(g.mesh is srv.mesh for g in groups)
    jsrv = jserver.AsciiChatServer()
    jsrv.mesh = jmesh.make_mesh(8, space=int(space or 1), devices=jax.devices("cpu"))
    jclients = _clients(jserver, jproto)
    jsrv._render_tick(jclients)
    for i, (a, b, c) in enumerate(zip(single, sharded, _sent(jclients))):
        assert len(a) == len(b) == len(c) == 1, f"client {i}"
        assert b[0] == a[0], f"client {i}: the sharded frame differs from the unsharded"
        assert b[0] == c[0], f"client {i}: the sharded frame differs from the JAX server's"


def test_live_render_tick_on_distinct_devices(monkeypatch):
    """The live _render_tick over a mesh of two devices (2 x 2, the
    devices in turn) sends what the unsharded tick sends, byte for byte,
    and counts the tick's one stack copy in ``mesh_collectives``."""
    single, _ = _port_tick(monkeypatch, "")
    mesh = _distinct_mesh("2x2")
    monkeypatch.setattr(tmesh, "serving_mesh", lambda device=None: mesh)
    sharded, srv = _port_tick(monkeypatch, "")
    assert srv.mesh is mesh
    assert srv.server_state()["mesh"] == {"clients": 2, "space": 2}
    assert srv.mesh_collectives == 1 and srv.server_state()["mesh_collectives"] == 1
    for i, (a, b) in enumerate(zip(single, sharded)):
        assert len(a) == len(b) == 1 and b[0] == a[0], f"client {i}"


# -- the server as a process -----------------------------------------------------

WAIT_S = 90.0
TERM_W, TERM_H = 40, 12


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_one_oracle_frame(port: int, frame: np.ndarray) -> None:
    """A raw ACIP client: send caps and ``frame``, read until a frame equals
    the oracle's, under WAIT_S."""
    plan = jcompositor.plan_composite([(frame.shape[1], frame.shape[0])], TERM_W, TERM_H)
    want = oracle.ascii_convert_with_capabilities(
        jcompositor.composite_reference(frame[None], plan), TERM_W, 2 * TERM_H, HB)

    async def session():
        t = await connect_tcp("127.0.0.1", port)
        try:
            wire = jproto.WireCapabilities(caps=HB, width=TERM_W, height=TERM_H,
                                           capabilities_mask=0x1)  # uncompressed
            await t.send(jpkt.PacketType.CLIENT_CAPABILITIES, wire.pack())
            await t.send(jpkt.PacketType.IMAGE_FRAME, jpkt.pack_image_frame(
                frame.tobytes(), frame.shape[1], frame.shape[0]))
            while True:
                ptype, payload = await t.recv()
                if (ptype == jpkt.PacketType.ASCII_FRAME
                        and jpkt.unpack_ascii_frame(payload)[0] == want):
                    return
        finally:
            await t.close()

    asyncio.run(asyncio.wait_for(session(), WAIT_S))


def wait_accepting(proc: subprocess.Popen, port: int) -> None:
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
                raise AssertionError("the server never accepted a connection") from None
            time.sleep(0.1)


def inspector_state(port: int, ready=lambda state: True) -> dict:
    """The inspector's /state/server, polled until ``ready(state)`` (a
    tick counts its render only after its frames are queued, so a client
    can hold a frame before the count moves), under WAIT_S."""
    end = time.monotonic() + WAIT_S
    while True:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state/server", timeout=10) as r:
            state = json.loads(r.read())
        if ready(state) or time.monotonic() > end:
            return state
        time.sleep(0.05)


@pytest.mark.parametrize("space, shape", [("", {"clients": 8}),
                                          ("2", {"clients": 4, "space": 2})], ids=["1d", "2d"])
def test_live_server_mesh_subprocess(space, shape):
    """tests/test_server_mesh.py:139 and :332 on the port: the server as a
    process under ASCIICHAT_FORCE_MESH=8 (and ASCIICHAT_MESH_SPACE=2) on
    the CPU serves a client oracle frames, and its inspector shows the mesh,
    no stack copy between devices and no failed tick."""
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", ASCIICHAT_FORCE_MESH="8",
               ASCIICHAT_MESH_SPACE=space, OMP_NUM_THREADS="1")
    port, insp = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "server", "--host",
         "127.0.0.1", "--port", str(port), "--inspect-port", str(insp),
         "--log-level", "WARNING"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        wait_accepting(proc, port)
        serve_one_oracle_frame(port, synthetic_frame(48, 64, seed=40))
        wait_accepting(proc, insp)
        state = inspector_state(insp, lambda st: st["tick_compute"] > 0)
        assert state["mesh"] == shape, state
        assert state["mesh_collectives"] == 0, state
        assert state["device"] == "cpu" and state["device_failures"] == 0, state
        assert state["tick_compute"] > 0, state
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
