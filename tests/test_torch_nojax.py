"""The port never imports JAX: every module of asciichat_tpu_torch and
chip_smoke.py's imports load with ``jax`` unimportable (nor do they import
the JAX package ``asciichat_tpu``: tests/test_torch_standalone.py), the
plaintext server and client need neither JAX nor ``cryptography``, and
chip_smoke.py fails without a card or outside a checkout, printing no
result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import asciichat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(asciichat_tpu_torch.__path__,
                                               "asciichat_tpu_torch.")]
assert "asciichat_tpu_torch.ops.rain" in names, names
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m == "jax" or m.startswith(("jax.", "jaxlib")))]
assert not loaded, loaded
print(len(names))
"""


def _run(args, cwd, timeout=120):
    # CUDA_VISIBLE_DEVICES="" hides any card, so "without a card" holds on
    # a machine that has one too
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax():
    out = _run(["-c", IMPORT_ALL], REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 15  # every module was walked


SERVER_IMPORTS = """
import sys
import asciichat_tpu_torch.apps.server
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "cryptography"))
assert not loaded, loaded
print("ok")
"""


def test_server_imports_neither_jax_nor_cryptography():
    """A plaintext server needs neither: the crypto modules load only for an
    encrypted session or an auth option."""
    out = _run(["-c", SERVER_IMPORTS], REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


CLIENT_IMPORTS = """
import sys
import asciichat_tpu_torch.apps.client
import asciichat_tpu_torch.runtime.audiodev
from asciichat_tpu_torch.apps.main import build_parser
build_parser().parse_args(["client", "127.0.0.1", "--tone-hz", "440"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "cryptography"))
assert not loaded, loaded
print("ok")
"""


def test_client_imports_neither_jax_nor_cryptography():
    """A plaintext client (with its audio sources and capture chain) needs
    neither: the handshake loads only for an encrypted session."""
    out = _run(["-c", CLIENT_IMPORTS], REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            pass
    return True


def test_chip_smoke_fails_without_a_card():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert _no_result(out.stdout)


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert _no_result(out.stdout)
