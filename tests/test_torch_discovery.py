"""The port's discovery on the CPU: the session database, word lists and
session strings (asciichat_tpu_torch/net/discovery.py), the rate limiter,
ring consensus (net/consensus.py), the discovery service (apps/acds.py,
``discovery-service``) and the discovery session (apps/discovery.py,
``discovery``: signed ACDS channel, ring, P2P links, host failover).

The JAX package's tests/test_discovery.py, all of it, and the ACDS and
discovery cases of tests/test_review_r04.py run here on the port's modules
(``test_torch_webrtc.port_jax_tests``). Across the packages: a port
participant joins a JAX discovery service and a JAX participant the
port's, and each side's signed envelopes verify on the other. As processes,
with ``asciichat_tpu`` blocked: ``discovery-service``, a ``discovery``
host and a joiner with ``--max-frames``; then host failover (the host is
killed, the survivor reports "host migrated"); ``strings`` prints what the
JAX package's prints. Ports come from ``bind(0)``; every wait is on a
readiness signal (a ``session:`` line, a port that accepts) under a limit
of its own, never a fixed sleep. What the processes write goes under the
test's ``tmp_path`` (``HOME`` and ``TMPDIR``)."""

import asyncio
import os
import random
import secrets
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from asciichat_tpu.apps import acds as jacds
from asciichat_tpu.apps import discovery as jdisc
from asciichat_tpu.apps import main as jmain
from asciichat_tpu.net import consensus as jcons
from asciichat_tpu.net import identity as jident
from asciichat_tpu.net import packet as jpkt
from asciichat_tpu.net import transport as jtransport
from asciichat_tpu.net.discovery import validate_session_string
from asciichat_tpu_torch.apps import acds as tacds
from asciichat_tpu_torch.apps import discovery as tdisc
from asciichat_tpu_torch.apps import main as tmain
from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.net import consensus as tcons
from asciichat_tpu_torch.net import identity as tident
from asciichat_tpu_torch.net import transport as ttransport

from test_torch_webrtc import port_jax_tests

REPO = Path(__file__).resolve().parent.parent
LIMIT = 60.0  # seconds for any one wait

REVIEW_CASES = (  # the ACDS and discovery cases of tests/test_review_r04.py
    "test_acds_relay_budget_covers_all_forwarded_types",
    "test_acds_non_host_session_end_degrades_to_leave",
    "test_acds_stale_binding_cannot_inject_after_session_end",
    "test_acds_session_switch_unbinds_previous_membership",
    "test_acds_rejects_oversized_participant_id",
    "test_acds_touch_throttled_and_membership_cached",
    "test_acds_election_loop_survives_db_error",
    "test_discovery_leave_closes_transport_without_session",
    "test_discovery_join_buffers_pre_ack_broadcasts",
    "test_acds_registration_replay_and_pin_squatting_blocked",
)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tserver.AsciiChatServer, "_tune_latency", lambda self: None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


port_jax_tests(globals(), "test_discovery.py")
port_jax_tests(globals(), "test_review_r04.py", only=REVIEW_CASES)



# -- across the packages -------------------------------------------------------

SIDES = {"jax": (jacds, jdisc, jcons, jtransport), "port": (tacds, tdisc, tcons, ttransport)}
OTHER = {"jax": "port", "port": "jax"}


@pytest.mark.parametrize("signer", ["jax", "port"])
def test_signed_envelopes_verify_across_packages(signer):
    """An Ed25519 envelope made by one package opens in the other, bound to
    its packet type; a tampered one and a replay as another type fail in
    both."""
    make, check = (jident, tident) if signer == "jax" else (tident, jident)
    me = make.Identity()
    body = b'{"host_id": "p-aaa", "host_port": 27230}'
    env = me.sign(jpkt.PacketType.ACIP_HOST_DESIGNATED, body)
    for mod in (check, make):
        assert mod.open_envelope(jpkt.PacketType.ACIP_HOST_DESIGNATED, env) == (
            me.public_bytes, body)
        with pytest.raises(mod.SignatureError):
            mod.open_envelope(jpkt.PacketType.ACIP_SESSION_JOIN, env)
        with pytest.raises(mod.SignatureError):
            mod.open_envelope(jpkt.PacketType.ACIP_HOST_DESIGNATED, env[:-1] + b"]")


@pytest.mark.parametrize("service", ["jax", "port"],
                         ids=["port-joins-jax-acds", "jax-joins-port-acds"])
def test_participants_across_packages(service):
    """One package's discovery service and three participants: the creator
    and the ring leader of the service's package, the best-placed
    participant of the other. Signed messages cross the packages: the
    joins, the participant lists, a ring round (stats relayed around the
    ring, the leader's signed election result verified by everyone), the
    service adopting the elected host for late joiners, and a forged
    result, which is rejected."""
    acds_mod, _, _, transport_mod = SIDES[service]
    quality = {  # participant -> (package, metrics)
        "p-aaa": (OTHER[service], dict(nat_tier=0, upload_kbps=50_000, rtt_ms=5)),
        "p-mmm": (service, dict(nat_tier=1, upload_kbps=20_000, rtt_ms=30)),
        "p-zzz": (service, dict(nat_tier=3, upload_kbps=2_000, rtt_ms=200)),
    }

    async def until(cond, what):
        end = asyncio.get_running_loop().time() + LIMIT
        while not cond():
            assert asyncio.get_running_loop().time() < end, f"timed out waiting for {what}"
            await asyncio.sleep(0.02)

    async def run():
        acds = acds_mod.AcdsServer("127.0.0.1", 0)
        srv = await transport_mod.serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        sessions = {}
        for pid, (side, q) in quality.items():
            _, disc_mod, cons_mod, _ = SIDES[side]
            sess = disc_mod.DiscoverySession("127.0.0.1", port, participant_id=pid)
            sess.metrics = lambda p=pid, s=sess, c=cons_mod, q=q: c.ParticipantMetrics(
                participant_id=p, address=s.my_address, port=s.my_port, **q)
            sess.attach_ring(interval_s=3600)  # the round is started below
            await sess.connect()
            sessions[pid] = sess
        string = await sessions["p-mmm"].create(my_port=15002, my_address="10.0.0.2")
        assert await sessions["p-aaa"].join(string, "10.0.0.1", 15001) == ("10.0.0.2", 15002)
        await sessions["p-zzz"].join(string, "10.0.0.3", 15003)
        events = [asyncio.create_task(s.event_loop()) for s in sessions.values()]
        try:
            await until(lambda: all(len(s.ring.cp.positions) == 3
                                    for s in sessions.values()), "the participant lists")
            leader = sessions["p-zzz"].ring
            assert leader.cp.is_leader and leader.start_round_if_leader()
            await until(lambda: leader.rounds_completed >= 1 and all(
                s.ring.results_verified >= 1 for p, s in sessions.items() if p != "p-zzz"),
                "the ring round")
            for sess in sessions.values():
                assert (sess.host_id, sess.host_address, sess.host_port) == (
                    "p-aaa", "10.0.0.1", 15001), sess.participant_id
            assert leader.cp.backup_id == "p-mmm"
            await until(lambda: acds.db.lookup(string).host_id == "p-aaa",
                        "the service adopting the elected host")
            forged = [sessions[p].metrics() for p in quality]
            sessions["p-mmm"].ring._send("p-aaa", {
                "type": "RING_ELECTION_RESULT", "round_id": 99,
                "host_id": "p-zzz", "backup_id": "p-mmm", "metrics": forged})
            await until(lambda: sessions["p-aaa"].ring.results_rejected >= 1,
                        "the forged result's rejection")
            assert sessions["p-aaa"].host_id == "p-aaa"
        finally:
            for task in events:
                task.cancel()
            for sess in sessions.values():
                await sess.leave()
            srv.close()

    asyncio.run(asyncio.wait_for(run(), 2 * LIMIT))


# -- strings -------------------------------------------------------------------

def _strings(main_mod, argv, capsys, monkeypatch) -> tuple[int, bytes]:
    """``strings`` of one package's CLI, in process, with the session
    strings drawn from a seeded generator: exit code and stdout."""
    monkeypatch.setattr(secrets, "choice", random.Random(3).choice)
    args = main_mod.build_parser().parse_args(["strings", *argv])
    code = args.fn(args)
    return code, capsys.readouterr().out.encode()


@pytest.mark.parametrize("argv", [
    ["--list-words"], ["--validate", "amber-anchor-arrow"],
    ["--validate", "swift-river-mountain"], ["--validate", "anchor-amber-arrow"],
    ["--validate", "amber-anchor"], ["--count", "5"], []],
    ids=["list-words", "validate-valid", "validate-unlisted-word",
         "validate-order", "validate-short", "count", "default"])
def test_strings_equal_to_the_jax_package(argv, capsys, monkeypatch):
    """Byte-equal output and the same exit code; generated strings (under
    the same draws) validate."""
    ours = _strings(tmain, argv, capsys, monkeypatch)
    assert ours == _strings(jmain, argv, capsys, monkeypatch)
    if "--validate" not in argv and "--list-words" not in argv:
        lines = ours[1].decode().splitlines()
        assert ours[0] == 0 and len(lines) == (5 if argv else 1)
        assert all(validate_session_string(line) for line in lines)


# -- as processes, with asciichat_tpu blocked -------------------------------------

BLOCK = ("import sys\n"
         "for name in ('asciichat_tpu', 'jax', 'jaxlib'):\n"
         "    sys.modules[name] = None\n")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _Proc:
    """``python -m asciichat_tpu_torch.apps.main ARGV`` with
    ``asciichat_tpu`` blocked, its output drained by threads (a full pipe
    would stall its event loop) and kept for the waits."""

    def __init__(self, tmp_path: Path, *argv: str):
        code = BLOCK + ("from asciichat_tpu_torch.apps.main import main\n"
                        f"sys.exit(main({list(argv)!r}))\n")
        env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
                   HOME=str(tmp_path), TMPDIR=str(tmp_path))
        env.pop("PYTHONPATH", None)
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.out, self.err = bytearray(), bytearray()
        self._threads = [threading.Thread(target=self._drain, args=(pipe, buf), daemon=True)
                         for pipe, buf in ((self.proc.stdout, self.out),
                                           (self.proc.stderr, self.err))]
        for thread in self._threads:
            thread.start()

    @staticmethod
    def _drain(pipe, buf: bytearray) -> None:
        for chunk in iter(lambda: pipe.read1(65536), b""):
            buf += chunk

    def wait_for(self, cond, what: str, limit: float = LIMIT) -> None:
        end = time.monotonic() + limit
        while not cond():
            if self.proc.poll() is not None and not cond():
                time.sleep(0.2)  # the drain threads catch up with the exit
                if cond():
                    return
                raise AssertionError(f"exited {self.proc.returncode} before {what}: "
                                     f"{self.err.decode(errors='replace')[-3000:]}")
            if time.monotonic() > end:
                raise AssertionError(f"timed out waiting for {what}: "
                                     f"{self.err.decode(errors='replace')[-3000:]}")
            time.sleep(0.05)

    def session(self) -> str:
        self.wait_for(lambda: b"\n" in self.out, "the session: line")
        line = self.out.split(b"\n", 1)[0].decode()
        assert line.startswith("session: "), line
        return line.split(": ", 1)[1]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        for thread in self._threads:
            thread.join(timeout=30)


def _accepts(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
        return True
    except OSError:
        return False


def _service(tmp_path: Path) -> tuple[_Proc, int]:
    port = _free_port()
    acds = _Proc(tmp_path, "discovery-service", "--host", "127.0.0.1", "--port", str(port),
                 "--log-level", "WARNING")
    acds.wait_for(lambda: _accepts(port), "the discovery service to accept")
    return acds, port


def _participant(tmp_path: Path, acds_port: int, *extra: str) -> tuple[_Proc, int]:
    port = _free_port()
    return _Proc(tmp_path, "discovery", "--acds", "127.0.0.1", "--acds-port", str(acds_port),
                 "--port", str(port), "--width", "40", "--height", "10", *extra), port


def test_discovery_processes_end_to_end(tmp_path):
    """``discovery-service``, a ``discovery`` host, and a joiner that
    receives 4 frames from the host's standby server and exits 0."""
    procs = []
    try:
        acds, acds_port = _service(tmp_path)
        procs.append(acds)
        host, host_port = _participant(tmp_path, acds_port, "--log-level", "WARNING")
        procs.append(host)
        string = host.session()
        assert validate_session_string(string)
        joiner, _ = _participant(tmp_path, acds_port, "--join", string, "--max-frames", "4",
                                 "--log-level", "WARNING")
        procs.append(joiner)
        assert joiner.proc.wait(timeout=2 * LIMIT) == 0, joiner.err.decode()[-3000:]
        joiner.stop()
        head = f"session: {string}\nhost: 127.0.0.1:{host_port}\n".encode()
        assert joiner.out.startswith(head)
        assert joiner.out.count(b"\x1b[") > 100  # frames from the host
        assert host.proc.poll() is None and acds.proc.poll() is None
        assert b"Traceback" not in host.err + joiner.err + acds.err
    finally:
        for proc in procs:
            proc.stop()


def test_host_failover_processes(tmp_path):
    """The host is killed mid-session: the service re-elects, and the
    survivor reports "host migrated", becomes the host and goes on
    receiving frames, now from its own standby server."""
    procs = []
    try:
        acds, acds_port = _service(tmp_path)
        procs.append(acds)
        host, _ = _participant(tmp_path, acds_port, "--log-level", "WARNING")
        procs.append(host)
        string = host.session()
        viewer, _ = _participant(tmp_path, acds_port, "--join", string,
                                 "--max-frames", "100000", "--log-level", "INFO")
        procs.append(viewer)
        viewer.wait_for(lambda: viewer.out.count(b"\x1b[") > 100, "frames from the host")
        host.proc.kill()  # SIGKILL: the host leaves no goodbye
        host.proc.wait(timeout=30)
        viewer.wait_for(lambda: b"host migrated" in viewer.err, "the host migration")
        seen = len(viewer.out)
        viewer.wait_for(lambda: viewer.out.count(b"\x1b[", seen) > 100,
                        "frames from the new host")
        assert viewer.proc.poll() is None
    finally:
        for proc in procs:
            proc.stop()


@pytest.mark.parametrize("argv", [["discovery-service", "--port", "0"],
                                  ["discovery", "--acds-port", "1"]],
                         ids=["discovery-service", "discovery"])
def test_modes_without_cryptography_say_so(argv, capsys, monkeypatch):
    """Without ``cryptography`` the discovery modes exit 1 with one line on
    stderr that names it, before they open a socket (``client --webrtc``:
    tests/test_torch_standalone.py)."""
    monkeypatch.setitem(sys.modules, "cryptography", None)
    assert tmain.main([*argv, "--log-level", "WARNING"]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "`cryptography`" in err and "Traceback" not in err
