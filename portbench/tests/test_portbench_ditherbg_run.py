"""run.py on a tiny cell of the background render mode, on the CPU: correct
with its metrics, the dither's rate read from the program's counter, and
wrong where the timed path dithers otherwise than the C renderer or where the
control stands in its place."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from conftest import make_tree
from harness import program_spans, spec

CELL, LIKE = "tiny.ditherbg", "ditherbg.1080p"
SEED = "4000000009"  # more than a signed 32-bit int holds

# run.py with the CPU for a card and, where argv[1] names a variant, the
# timed call replaced by the reference with that variant of its dither.
RUN_VARIANT = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, "portbench")
import run
from harness import spec
from reference.render import Reference, load_mode
from asciichat_tpu_torch.render import pipeline

run.find_devices = lambda chips: torch.device("cpu")
variant = sys.argv[1]
mode = load_mode("16color_dithered_bg")
if variant == "rounded":  # the carries' division rounds to nearest, not toward zero
    mode.div16 = lambda v: np.sign(v) * ((np.abs(v) + 8) // 16)
elif variant == "no_next_row":  # no error carried to the row below
    mode.WEIGHTS = np.array([7, 0, 0, 0], np.int64)[:, None, None]
conf = spec.load_cell(run.ROOT, sys.argv[3], traced=False).config


def convert(self, frames, width, height, caps, use_aspect_ratio=True):
    frames = frames.numpy()
    ref = Reference(conf, frames.shape[1], frames.shape[2])
    ref.mode = mode
    return [ref.frame(f) for f in frames]


if variant != "none":
    pipeline.AsciiRenderer.convert_batch = convert
sys.exit(run.main(sys.argv[2:]))
'''


def args(trace: int = 0, seconds: float = 0.6) -> list[str]:
    return ["--workload", CELL, "--seed", SEED, "--seconds", str(seconds), "--trace", str(trace)]


def drive(tree: Path, variant: str, trace: int = 0):
    """-> (exit code, the result line's dict or None, stderr)."""
    proc = subprocess.run([sys.executable, "-c", RUN_VARIANT, variant, *args(trace)],
                          cwd=tree, capture_output=True, text=True, timeout=240)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc.returncode, result, proc.stderr


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """A checkout with the tiny cell: ditherbg-203x64 at 40x12 on the tiny
    traffic, reporting what ditherbg.1080p reports."""
    tree = make_tree(tmp_path_factory.mktemp("checkout"))
    pb = tree / "portbench"
    conf = json.loads((pb / "configs" / "ditherbg-203x64.json").read_text())
    conf.update(width=40, height=12)
    (pb / "configs" / "tiny-ditherbg.json").write_text(json.dumps(conf))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-ditherbg", "source": "tiny", "reduced": [],
                             "why": "tests", "file": "portbench/configs/tiny-ditherbg.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny-ditherbg", "traffic": "tiny",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tree / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tree


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct(tree, trace):
    rc, result, err = drive(tree, "none", trace)
    assert rc == 0, err[-3000:]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert all(c == {"value": 0, "limit": 0} for c in result["checks"].values())
    if trace:
        # the CPU has no device trace: device_idle_pct is left out
        assert {"dither_mcells_per_s", "emit_native_ms", "emit_copy_ms",
                "kernel_setup_s"} <= set(result["metrics"])
        assert result["metrics"]["dither_mcells_per_s"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("variant", ["rounded", "no_next_row"])
def test_a_dither_unlike_the_c_renderers_is_not_correct(tree, variant):
    rc, result, err = drive(tree, variant)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert result["checks"]["sampled_frames_wrong"]["value"] > 0


def test_control_is_not_correct_on_any_sampled_frame(tree, monkeypatch):
    """The control's frames are wrong wherever they are compared byte for
    byte. Unsampled frames are judged by length, and a frame's length counts
    only its cells of a bright background (ESC[10Xm, a byte longer than
    ESC[4Xm): a different dither keeps it now and then (about 1 frame in 100
    at the cell's size, more at this one), so not every frame reads wrong."""
    import torch
    monkeypatch.setattr(spec, "BENCH_DIR", tree / "portbench")
    cell = spec.load_cell(tree, CELL, traced=False)
    for seed in (3, 5000000003):
        v = spec.path(cell.config).control_verdict(cell, seed, 0.3, torch.device("cpu"))
        assert not v.correct and v.attempted > 0 and v.sampled > 0
        assert v.checks["sampled_frames_wrong"]["value"] == v.sampled
        assert v.failed >= 0.9 * v.attempted


def record(seconds: float, counts: dict) -> SimpleNamespace:
    return SimpleNamespace(name="render.emit.native", start_ns=0, end_ns=int(seconds * 1e9),
                           counts=counts)


def test_dither_rate_reads_only_the_spans_that_dithered(monkeypatch):
    """Cells over the seconds of the native spans that counted them; nothing
    where no span did (a program without the counter, or another mode)."""
    def rate(spans):
        monkeypatch.setattr(program_spans, "window_records", lambda run, name: spans)
        return spec.reader("dither_mcells_per_s")(SimpleNamespace())

    spans = [record(0.002, {"ansi_bytes": 9, "dithered_cells": 1_000_000}),
             record(0.003, {"ansi_bytes": 9, "dithered_cells": 500_000}),
             record(0.010, {"ansi_bytes": 9})]
    assert rate(spans) == pytest.approx(1.5 / 0.005)
    assert rate(spans[2:]) is None
    assert rate(None) is None
