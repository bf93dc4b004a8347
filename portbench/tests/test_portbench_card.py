"""One short run of each cell on the card (skips without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_correct_on_the_card(card, trace):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell["name"], "--seed", "4100000003",
             "--seconds", "2", "--trace", str(trace)],
            cwd=REPO, capture_output=True, text=True, timeout=360)
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
