"""The port's CLI beyond its modes: the TOML store with presets and
``--config``/``--preset`` (``utils/options.py``, ``apps/main.apply_config``),
``completions`` and ``manpage``, ``query`` (``apps/query.py``) and the
SIGUSR1 dump channel (``utils/dumps.py``), the SIGUSR2 gc report and the
panic hook (``apps/main.install_handlers``), on the CPU.

The JAX package's tests of these run on the port's modules through
``port_jax_tests`` (each file compiled with ``asciichat_tpu.`` retargeted to
``asciichat_tpu_torch.``): all of tests/test_query.py, three cases of
tests/test_subsystems.py and eight of tests/test_review_r04.py. Where a JAX
test spawns the JAX package's CLI, the port's own version spawns the
port's (``test_cli_config_layering``). Then parity: the four shells'
completions and the man page are the JAX package's bytes, the namespace a
mode gets after ``--config``/``--preset`` is the one the JAX package's
``main()`` hands its mode, and ``query`` reports the Python stacks of a
deadlocked process of the port, both run with ``asciichat_tpu`` blocked."""

import faulthandler
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from asciichat_tpu.apps import main as jmain
from asciichat_tpu.utils import options as jopt
from asciichat_tpu_torch.apps import main as tmain

from test_torch_webrtc import port_jax_tests

REPO = Path(__file__).resolve().parent.parent
BLOCK = ("import sys\n"
         "for name in ('asciichat_tpu', 'jax', 'jaxlib'):\n"
         "    sys.modules[name] = None\n")


@pytest.fixture(autouse=True)
def _process_hooks():
    """main() installs process-wide handlers (SIGUSR1 dumps, SIGUSR2, the
    panic hook), as the CLI does: put the test worker's back afterwards."""
    hook, usr2 = sys.excepthook, signal.getsignal(signal.SIGUSR2)
    yield
    sys.excepthook = hook
    signal.signal(signal.SIGUSR2, usr2)
    faulthandler.unregister(signal.SIGUSR1)


port_jax_tests(globals(), "test_query.py")
port_jax_tests(globals(), "test_subsystems.py", only={
    "test_options_toml_and_presets", "test_options_generators",
    "test_mmap_ring_log_and_doc_generators"})
port_jax_tests(globals(), "test_review_r04.py", only={
    "test_toml_cli_type_options_convert", "test_publish_none_resets_option",
    "test_toml_unknown_toplevel_key_raises", "test_completions_escape_quotes",
    "test_manpage_shows_zero_defaults", "test_toml_numeric_scalar_takes_cli_type",
    "test_toml_layering_applies_only_file_keys", "test_main_config_precedence_end_to_end"})


def _env() -> dict:
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def test_cli_config_layering(tmp_path):
    """tests/test_subsystems.py::test_cli_config_layering on the port's CLI:
    ``--config`` TOML and ``--preset`` fill the options not typed, and a
    typed option wins."""
    cfg = tmp_path / "c.toml"
    cfg.write_text(
        "[display]\nwidth = 52\nstretch = true\ncolor-mode = \"none\"\n"
        "[preset.tiny]\n[preset.tiny.display]\nwidth = 30\n"
    )

    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "mirror",
             "--test-pattern", "--snapshot", "--height", "6", "--config", str(cfg), *extra],
            env=_env(), cwd=REPO, capture_output=True, timeout=180)
        assert out.returncode == 0, out.stderr.decode()[-800:]
        # columns of each line: ESC[Nb repeats the previous character N times
        return [sum(int(m[1]) if m[1] else 1 for m in re.finditer(r"\x1b\[(\d+)b|.", ln))
                for ln in out.stdout.decode().rstrip("\n").split("\n")]

    assert run() == [52] * 6
    assert run("--preset", "tiny") == [30] * 6
    assert run("--width", "20") == [20] * 6


@pytest.mark.parametrize("argv", [["completions", "bash"], ["completions", "zsh"],
                                  ["completions", "fish"], ["completions", "pwsh"],
                                  ["manpage"]], ids=lambda a: a[-1])
def test_generated_text_equals_the_jax_packages(argv, capsys):
    reg = jopt.default_registry()
    want = (jopt.generate_manpage(reg) if argv == ["manpage"]
            else jopt.generate_completions(reg, argv[1]))
    assert tmain.main(argv) == 0
    assert capsys.readouterr().out == want + "\n"


TOML = """
[display]
width = 100
height = 0
palette = "blocks"
color-mode = "256"
[network]
port = 4321
compress = 5
[media]
stdin-size = "640x480"
[log]
log-level = "ERROR"
[preset.p.display]
width = 60
render-mode = 2
[preset.p.network]
compress = 9
"""
MODE_ARGV = {"mirror": ["mirror", "--test-pattern"], "server": ["server"],
             "client": ["client", "1.2.3.4"], "discovery-service": ["discovery-service"],
             "discovery": ["discovery"]}
MODE_RUNNERS = {  # the JAX package's module whose main() runs the mode
    "server": "server", "client": "client", "discovery-service": "acds",
    "discovery": "discovery"}
PORT_RUNNERS = {"mirror": "cmd_mirror", "server": "cmd_server", "client": "cmd_client",
                "discovery-service": "cmd_acds", "discovery": "cmd_discovery"}


@pytest.mark.parametrize("extra", [[], ["--preset", "p"], ["--preset", "p", "--width", "77",
                                                           "--log-level=WARNING"]],
                         ids=["file", "preset", "typed"])
@pytest.mark.parametrize("mode", list(MODE_ARGV))
def test_config_namespace_equals_the_jax_packages(mode, extra, tmp_path, monkeypatch):
    """What each mode's runner receives from main() after the layering is
    the JAX package's namespace on the same argv and file, but for the
    runner itself."""
    import importlib

    cfg = tmp_path / "c.toml"
    cfg.write_text(TOML)
    argv = [*MODE_ARGV[mode], "--config", str(cfg), *extra]
    seen = {}

    def capture(name):
        def run(args):
            seen[name] = {k: v for k, v in vars(args).items() if k != "fn"}
            return 0
        return run

    if mode == "mirror":
        monkeypatch.setattr(jmain, "cmd_mirror", capture("jax"))
    else:
        mod = importlib.import_module(f"asciichat_tpu.apps.{MODE_RUNNERS[mode]}")
        monkeypatch.setattr(mod, "main", capture("jax"))
    monkeypatch.setattr(tmain, PORT_RUNNERS[mode], capture("port"))
    assert jmain.main(list(argv)) == 0
    assert tmain.main(list(argv)) == 0
    assert seen["port"] == seen["jax"]
    want = 77 if "--width" in extra else 60 if extra else 100
    assert seen["port"]["width"] == want
    assert seen["port"]["log_level"] == ("WARNING" if "--width" in extra else "ERROR")


# -- query against a deadlocked process of the port ------------------------------

HUNG = BLOCK + """
import threading
from asciichat_tpu_torch.apps.main import install_handlers
install_handlers()  # what main() installs before every mode

a, b = threading.Lock(), threading.Lock()
held_a, held_b = threading.Event(), threading.Event()
def grab_ab():
    with a:
        held_a.set(); held_b.wait()
        with b:
            pass
def grab_ba():
    with b:
        held_b.set(); held_a.wait()
        with a:
            pass
t1 = threading.Thread(target=grab_ab, name="ab")
t2 = threading.Thread(target=grab_ba, name="ba")
t1.start(); t2.start()
held_a.wait(); held_b.wait()  # each holds the lock the other needs
print("DEADLOCKED", flush=True)
t1.join(); t2.join()
"""


def query_report(pid: int) -> dict:
    """``apps.main query PID`` of the port, run with ``asciichat_tpu``
    blocked: its JSON report."""
    code = BLOCK + ("from asciichat_tpu_torch.apps.main import main\n"
                    f"sys.exit(main(['query', '{pid}']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    return json.loads(out.stdout)


def test_query_reports_a_deadlocked_port_process():
    """A process of the port (the port's handlers, ``asciichat_tpu``
    blocked) deadlocks two threads; the port's ``query`` (also blocked)
    reads their Python stacks through the SIGUSR1 channel, and its /proc
    state."""
    proc = subprocess.Popen([sys.executable, "-c", HUNG], cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE)
    try:
        assert proc.stdout.readline().strip() == b"DEADLOCKED"
        report = query_report(proc.pid)
        assert "grab_ab" in report["pystacks"] and "grab_ba" in report["pystacks"], \
            report["pystacks"][:800]
        assert int(report["status"]["Threads"]) >= 3
        assert "asciichat_tpu_torch" in report["status"]["cmdline"]
        assert report["fds"] and report["kstacks"]
        assert proc.poll() is None  # inspected, not killed
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_panic_hook_writes_a_report(tmp_path):
    """An unhandled exception after main()'s handlers writes the panic
    report with its traceback and the thread stacks, then dies as Python
    does."""
    code = BLOCK + ("from asciichat_tpu_torch.apps.main import install_handlers\n"
                    "install_handlers()\n"
                    "def explode():\n"
                    "    raise RuntimeError('boom')\n"
                    "explode()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(_env(), TMPDIR=str(tmp_path)), capture_output=True,
                         timeout=120)
    assert out.returncode == 1
    reports = list(tmp_path.glob("asciichat-panic-*.txt"))
    assert len(reports) == 1, out.stderr.decode()
    text = reports[0].read_text()
    assert text.startswith("asciichat-tpu panic report") and "RuntimeError: boom" in text
    assert "--- threads ---" in text and "MainThread" in text
    err = out.stderr.decode()
    assert f"panic report written to {reports[0]}" in err and "RuntimeError: boom" in err


def test_sigusr2_prints_the_gc_report():
    code = BLOCK + ("import os, signal, time\n"
                    "from asciichat_tpu_torch.apps.main import install_handlers\n"
                    "install_handlers()\n"
                    "os.kill(os.getpid(), signal.SIGUSR2)\n"
                    "time.sleep(0.1)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stderr.startswith("--- gc: counts=(") and " objects=" in out.stderr


def _without_sigcgt(monkeypatch):
    """Make the port's query see a /proc that reports no signal
    dispositions (no Sig* lines in /proc/<pid>/status), as some user-space
    kernels do."""
    from asciichat_tpu_torch.apps import query

    read = query._read

    def read_without_sig(path: str) -> str:
        text = read(path)
        if path.endswith("/status"):
            text = "\n".join(ln for ln in text.splitlines() if not ln.startswith("Sig"))
        return text

    monkeypatch.setattr(query, "_read", read_without_sig)
    return query


def test_query_without_sigcgt_reads_a_registered_process(monkeypatch):
    """Without SigCgt the port's query takes the line that the target's
    channel appends to its dump file once registered, written since the
    target started, as the registered channel, and reads the deadlocked
    threads' stacks."""
    query = _without_sigcgt(monkeypatch)
    proc = subprocess.Popen([sys.executable, "-c", HUNG], cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE)
    try:
        assert proc.stdout.readline().strip() == b"DEADLOCKED"
        assert query._start_time(proc.pid) is not None
        assert query._catches_sigusr1(proc.pid)
        out = query.python_stacks(proc.pid)
        assert "grab_ab" in out and "grab_ba" in out, out[:800]
        # a target that started after its dump file last changed is not trusted
        monkeypatch.setattr(query, "_start_time", lambda pid: float("inf"))
        assert not query._catches_sigusr1(proc.pid)
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_query_without_sigcgt_never_signals_an_unregistered_process(monkeypatch):
    """Without SigCgt, a process that never registered the channel (no dump
    file of its own) is not signalled, though its command line looks like
    asciichat: SIGUSR1 would kill it."""
    query = _without_sigcgt(monkeypatch)
    child = subprocess.Popen([sys.executable, "-c", "import sys; print('R', flush=True); "
                              "sys.stdin.read()  # asciichat look-alike"],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        assert child.stdout.readline() == b"R\n"
        assert not query._catches_sigusr1(child.pid)
        assert query.python_stacks(child.pid, timeout=1.0) == ""
        assert child.poll() is None, "query killed the uninspectable target"
    finally:
        child.kill()
        child.wait()
        child.stdout.close()
        child.stdin.close()


def test_query_without_sigcgt_never_signals_a_failed_registration(monkeypatch, tmp_path):
    """Without SigCgt, a process whose registration failed after its dump
    file was created (the file is there, fresh and its own, but holds no
    registered line) is not signalled: it has no handler, and SIGUSR1
    would kill it."""
    query = _without_sigcgt(monkeypatch)
    code = BLOCK + ("import faulthandler\n"
                    "def refuse(*args, **kwargs):\n"
                    "    raise ValueError('registration refused')\n"
                    "faulthandler.register = refuse\n"
                    "from asciichat_tpu_torch.utils.dumps import dump_path, install_dump_handlers\n"
                    "assert install_dump_handlers() is None\n"
                    "print(dump_path(), flush=True)\n"
                    "sys.stdin.read()\n")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                             env=dict(_env(), TMPDIR=str(tmp_path)),
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        path = Path(child.stdout.readline().decode().strip())
        assert path.parent == tmp_path and path.is_file()
        assert Path(query._target_dump_path(child.pid)) == path
        assert not query._catches_sigusr1(child.pid)
        assert query.python_stacks(child.pid, timeout=1.0) == ""
        assert child.poll() is None, "query killed the uninspectable target"
    finally:
        child.kill()
        child.wait()
        child.stdout.close()
        child.stdin.close()
