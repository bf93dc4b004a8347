"""The port's ``bench`` mode (apps/bench.py) on the CPU.

``ASCIICHAT_BENCH_SMOKE=1 ASCIICHAT_TORCH_DEVICE=cpu python -m
asciichat_tpu_torch.apps.main bench`` runs in a subprocess with
``asciichat_tpu`` and JAX blocked: it exits 0 with one JSON line on stdout,
the byte gate passed, ``smoke`` true and the keys of the JAX script's line
(``hlo_fingerprint`` become ``kernel_fingerprint``, plus
``server_tick_rate`` and ``eager_convert_fps``). A corrupted emitter fails
the gate (``value`` 0.0, exit 1); a fault injected into the server tick
ends the run with exit 1 and no line; without a card the mode says so in
one line and exits 1. Numbers from these runs are not measurements."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.apps import bench
from asciichat_tpu_torch.runtime import kernel_build

REPO = Path(__file__).resolve().parent.parent
LIMIT = 240  # seconds for any one bench subprocess (a smoke run takes ~15-30 s)
BLOCK = ("import sys\n"
         "for name in ('asciichat_tpu', 'jax', 'jaxlib'):\n"
         "    sys.modules[name] = None\n")
RUN = "import runpy\nrunpy.run_module('asciichat_tpu_torch.apps.main', run_name='__main__')\n"
KEYS = {"metric", "value", "unit", "vs_baseline", "eager_convert_fps",
        "emit_under_concurrency_fps", "end_to_end_onbox_fps",
        "end_to_end_pcie_projection_fps", "host_emit_fps", "host_emit_fps_mt",
        "host_emit_mt_threads", "pipeline_convert_fps", "pipeline_d2h_fps",
        "pipeline_d2h_mbps", "server_tick_rate", "kernel_fingerprint", "datachannel_fps",
        "versions", "smoke"}


def _bench(prelude: str = "", **env) -> subprocess.CompletedProcess:
    environ = dict(os.environ, ASCIICHAT_BENCH_SMOKE="1", ASCIICHAT_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="2", **env)
    environ.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", BLOCK + prelude + RUN, "bench"], cwd=REPO,
                          env=environ, capture_output=True, text=True, timeout=LIMIT)


def test_bench_smoke_prints_one_json_line():
    out = _bench()
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    assert set(line) == KEYS
    assert "byte-exactness gate: OK" in out.stderr
    assert line["metric"] == "1080p_truecolor_ascii_fps_per_chip" and line["unit"] == "frames/s"
    assert line["smoke"] is True
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / 10_000
    assert line["server_tick_rate"] > 0 and line["eager_convert_fps"] > 0
    for key in ("pipeline_convert_fps", "pipeline_d2h_fps", "emit_under_concurrency_fps",
                "host_emit_fps", "host_emit_fps_mt"):
        assert line[key] > 0, key
    assert line["end_to_end_onbox_fps"] == min(line["pipeline_convert_fps"],
                                               line["pipeline_d2h_fps"],
                                               line["emit_under_concurrency_fps"])
    assert line["kernel_fingerprint"] == kernel_build.library_digest()
    assert line["versions"]["platform"] == "cpu"
    assert line["versions"]["torch"] == torch.__version__
    # the DataChannel runs here (libssl and cryptography); elsewhere it is null
    assert line["datachannel_fps"] is None or line["datachannel_fps"] > 0


CORRUPT_EMITTER = """
from asciichat_tpu_torch.render import emitter
_emit = emitter.emit_frames
def emit_frames(*a, **k):
    out = _emit(*a, **k)
    first = bytearray(out[0])
    first[len(first) // 2] ^= 1
    return [bytes(first)] + list(out[1:])
emitter.emit_frames = emit_frames
"""


def test_bench_gate_refuses_a_corrupted_emitter():
    out = _bench(CORRUPT_EMITTER)
    assert out.returncode == 1, out.stderr[-3000:]
    assert json.loads(out.stdout) == {"metric": "1080p_truecolor_ascii_fps_per_chip",
                                      "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0}
    assert "FATAL" in out.stderr


TICK_FAULT = """
from asciichat_tpu_torch.models import server
def render_group(*a, **k):
    raise RuntimeError("injected K3 fault")
server.render_group = render_group
"""


def test_bench_ends_on_a_server_tick_fault():
    out = _bench(TICK_FAULT)
    assert out.returncode == 1
    assert "injected K3 fault" in out.stderr
    assert "byte-exactness gate: OK" in out.stderr  # it got that far
    assert out.stdout == ""  # no line: the stage is not skipped


def test_bench_without_a_card_says_so():
    """The default device is the card: without one, one line and exit 1
    (CUDA_VISIBLE_DEVICES="" hides a card where there is one)."""
    environ = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    environ.pop("ASCIICHAT_TORCH_DEVICE", None)
    environ.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", BLOCK + RUN, "bench"], cwd=REPO, env=environ,
                         capture_output=True, text=True, timeout=LIMIT)
    assert out.returncode == 1
    assert out.stdout == ""
    assert len(out.stderr.strip().splitlines()) == 1, out.stderr
    assert "ASCIICHAT_TORCH_DEVICE=cpu" in out.stderr


@pytest.mark.parametrize("b,h,w", [(5, 7, 300), (12, 3, 2)])
def test_frames_are_the_jax_scripts_gradient(b, h, w):
    """bench.py:86-95 in int32, against the port's uint8 build (its sums
    wrap mod 256)."""
    yy = np.arange(h, dtype=np.int32)[:, None]
    xx = np.arange(w, dtype=np.int32)[None, :]
    bidx = np.arange(b, dtype=np.int32)[:, None, None]
    zero = np.zeros((b, h, w), np.int32)
    want = np.stack([zero + ((xx * 255) // (w - 1) + bidx * 7) % 256,
                     zero + ((yy * 255) // (h - 1) + bidx * 13) % 256,
                     zero + (xx + yy + bidx * 29) % 256], axis=-1).astype(np.uint8)
    got = bench.make_frames(b, h, w, torch.device("cpu"))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_differencing_falls_back_to_the_long_loop(monkeypatch, capsys):
    """When the short loop never runs faster than the long one, the JAX
    method's three attempts end in the long loop's raw time per call."""
    times = iter([0.9, 0.4] * (bench.REPS * bench.RETRIES))
    monkeypatch.setattr(bench, "seconds", lambda fn, cuda: next(times))
    per_call = bench.differenced(lambda: None, False, "test loop")
    assert per_call == 0.4 / bench.LOOPS[1]
    err = capsys.readouterr().err
    assert err.count("retrying") == bench.RETRIES and "WARNING" in err

