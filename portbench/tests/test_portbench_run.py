"""run.py end to end on the CPU at tiny sizes: no card, no program, the
result line, the faults that the check has to catch, the control, and a cell
made of new files only."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, REPO, drive, make_tree

import control as control_script
import run as run_script

FORBIDDEN_IN_RUN = {"jax", "jaxlib", "flax", "asciichat_tpu"}
SEED = "4000000007"  # more than a signed 32-bit int holds


def args(cell: str, trace: int = 0, seconds: float = 0.6, seed: str = SEED) -> list[str]:
    return ["--workload", cell, "--seed", seed, "--seconds", str(seconds), "--trace", str(trace)]


def test_without_a_card_exits_nonzero_with_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", *args("truecolor.1080p")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_without_the_program_exits_nonzero_with_no_result(tmp_path):
    tree = make_tree(tmp_path / "bare", with_program=False)
    rc, result, err = drive(tree, args("tiny.tc"))
    assert rc != 0 and result is None
    assert "asciichat_tpu_torch" in err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny.tc", "tiny.hb"])
def test_tiny_cell_is_correct(tree, cell, trace):
    rc, result, err = drive(tree, args(cell, trace))
    assert rc == 0, err[-3000:]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in result["checks"].values())
    want = {("tiny.tc", 0): {"setup_s"}, ("tiny.tc", 1): {"host_frames_per_s"},
            ("tiny.hb", 0): {"frames_per_s", "setup_s"},
            ("tiny.hb", 1): {"pipeline_other_ms", "fetch_ms", "emit_ms"}}[cell, trace]
    assert want <= set(result["metrics"])
    assert result["device"]["count"] == 1
    # the compared numbers close standard error, each with its limit
    tail = err.strip().splitlines()[-3:]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in result["checks"]]


def test_run_command_loads_nothing_of_jax(tree):
    probe = ("import sys, torch; sys.path.insert(0, 'portbench'); import run; "
             "run.find_devices = lambda chips: torch.device('cpu'); "
             f"rc = run.main({args('tiny.hb', 1)!r}); "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tree, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "asciichat_tpu_torch" in loaded
    assert not loaded & FORBIDDEN_IN_RUN


def test_benchmark_sources_import_nothing_of_jax():
    for path in BENCH_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN_IN_RUN, (path, name)


def test_sample_store_keeps_whole_frames_and_rows_are_replaced():
    from harness.window import SampleStore
    store = SampleStore(2, 8)
    store.put(0, b"abc")
    store.put(1, b"0123456789")  # wider than a row
    assert store.get(0) == b"abc" and store.get(1) == b"0123456789"
    store.put(1, b"xy")
    assert store.get(1) == b"xy"


def test_guard_compares_whole_top_level_names():
    from harness.guard import forbidden_loaded
    assert forbidden_loaded(["asciichat_tpu_torch.ops.cells", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["asciichat_tpu.ops", "jax.numpy", "jaxlib"]) == [
        "asciichat_tpu", "jax", "jaxlib"]


PROCESS_PROBE = r'''
import json, os, sys
sys.path.insert(0, "portbench")
from harness import process
conf = json.load(open(sys.argv[1]))
print(json.dumps([process.apply(conf), os.environ.get("ASCIICHAT_EMIT_THREADS")]))
'''


@pytest.mark.parametrize("config", ["truecolor-203x64", "halfblock-203x64"])
def test_process_settings_of_each_configuration_apply_before_the_program(config):
    path = BENCH_DIR / "configs" / f"{config}.json"
    proc = json.loads(path.read_text())["process"]
    out = subprocess.run([sys.executable, "-c", PROCESS_PROBE, str(path)], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    done, threads = json.loads(out)
    assert threads == proc["environment"]["ASCIICHAT_EMIT_THREADS"]
    assert done == [f"{k}={v}" for k, v in proc["environment"].items()] + [
        f"mallopt {k}={v}" for k, v in proc["mallopt"].items()]
    src = (BENCH_DIR / "run.py").read_text()
    assert src.index("process.apply(conf)") < src.index("path.Bench(")


def test_an_unknown_allocator_option_is_refused():
    from harness import process
    with pytest.raises(KeyError):
        process.apply({"process": {"mallopt": {"M_NO_SUCH_OPTION": 1}}})


@pytest.mark.parametrize("fault", ["stale", "half", "half_repeated", "altered"])
@pytest.mark.parametrize("cell", ["tiny.tc", "tiny.hb"])
def test_a_fault_under_the_timed_path_is_not_correct(tree, cell, fault):
    rc, result, err = drive(tree, args(cell), fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["tiny.tc", "tiny.hb"])
def test_control_is_not_correct(tree, cell, monkeypatch):
    import torch
    monkeypatch.setattr(run_script, "ROOT", tree)
    monkeypatch.setattr(run_script, "find_devices", lambda chips: torch.device("cpu"))
    monkeypatch.setattr(control_script.spec, "BENCH_DIR", tree / "portbench")
    seeds = ["1", "2", "5000000001"]
    assert control_script.main(["--workload", cell, "--seeds", *seeds, "--seconds", "0.3"]) == 0


MONO_MODE = '''
"""Monochrome: image_print, lib/video/ascii/scalar/foreground.c:27-138."""
import numpy as np
from reference.palette import characters

ROWS_PER_CELL = 1
RECORD_BYTES_PER_CELL = 1


def render(pixels, palette):
    chars = characters(palette)
    n = len(chars)
    ramp = [min(n - 1, (i * (n - 1) + 31) // 63) for i in range(64)]
    p = pixels.astype(np.int64)
    luma = np.clip((77 * p[..., 0] + 150 * p[..., 1] + 29 * p[..., 2] + 128) >> 8, 0, 255)
    lines = []
    for row in luma.tolist():
        keys = [ramp[v >> 2] for v in row]
        out, x = [], 0
        while x < len(keys):
            j = x
            while j < len(keys) and keys[j] == keys[x]:
                j += 1
            glyph, extra = chars[ramp[keys[x]]], j - x - 1
            out.append(glyph)
            out.append(b"\\x1b[%db" % extra if extra + 1 > 2 and extra > len(str(extra)) + 3
                       else glyph * extra)
            x = j
        lines.append(b"".join(out))
    return b"\\n".join(lines)
'''

CALLS_METRIC = '''
def read(run):
    return len(run.window.calls) / run.window.seconds if run.trace is not None else None
'''


def test_cell_config_mode_traffic_and_metric_from_new_files_only(tmp_path):
    tree = make_tree(tmp_path / "grown")
    before = {p: p.read_bytes() for p in (tree / "portbench").rglob("*") if p.is_file()}
    pb = tree / "portbench"
    conf = json.loads((pb / "configs" / "truecolor-203x64.json").read_text())
    conf.update(name="mono-30x10", mode="mono", color_level="NONE", width=30, height=10)
    (pb / "configs" / "mono-30x10.json").write_text(json.dumps(conf))
    (pb / "reference" / "modes" / "mono.py").write_text(MONO_MODE)
    traffic = json.loads((pb / "traffic" / "tiny.json").read_text())
    traffic.update(source_w=64, source_h=40, batch=3)
    (pb / "traffic" / "tiny.b3.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "calls_per_s.py").write_text(CALLS_METRIC)
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mono-30x10", "source": "tests", "reduced": [],
                             "why": "tests", "file": "portbench/configs/mono-30x10.json"})
    bench["workloads"].append({"name": "mono.tiny", "config": "mono-30x10",
                               "traffic": "tiny.b3", "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "frames_per_s",
                               "workloads": ["mono.tiny"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, result, err = drive(tree, args("mono.tiny", 1))
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_per_s"]["value"] > 0
    assert result["attempted"] % 3 == 0
    rc, result, err = drive(tree, args("tiny.tc", 1))
    assert rc == 0 and result["correct"] and "calls_per_s" not in result["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


# The server's tick (paths/server_tick.py) at a tiny size: 3 clients of
# 64x48 in 3 geometry groups, on the port's plain CPU path.

TICK_METRICS = {"tick_fill_ms", "tick_upload_ms", "tick_fetch_ms", "tick_emit_ms",
                "tick_pack_ms", "kernel_setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_tick_is_correct(tree, trace):
    rc, result, err = drive(tree, args("tiny.tick", trace, seed="4200000011"))
    assert rc == 0, err[-3000:]
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 3 == 0
    assert all(c == {"value": 0, "limit": 0} for c in result["checks"].values())
    assert set(result["checks"]) == {"payloads_count_off", "payload_headers_wrong",
                                     "payloads_wrong_length", "sampled_payloads_wrong"}
    assert set(result["metrics"]) == (TICK_METRICS if trace else {"frames_per_s", "setup_s"})
    if trace:
        names = {n for n, _ in result["breakdown"]["idle_gaps"]}
        assert names <= {"upload_stack", "render_groups", "fetch", "emit_frames",
                         "pack_ascii_frame", "render_tick_other", "between_calls"}
    tail = err.strip().splitlines()[-4:]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in result["checks"]]


@pytest.mark.parametrize("fault", ["tick_receiver_dropped", "tick_byte_altered",
                                   "tick_stale_source", "tick_sent_twice"])
def test_a_fault_under_the_tick_is_not_correct(tree, fault):
    rc, result, err = drive(tree, args("tiny.tick"), fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["tiny.tc", "tiny.hb", "tiny.tick"])
def test_control_reads_every_frame_wrong(tree, cell, monkeypatch):
    import torch
    monkeypatch.setattr(control_script.spec, "BENCH_DIR", tree / "portbench")
    from harness import spec
    loaded = spec.load_cell(tree, cell, traced=False)
    for seed in (3, 5000000003):
        v = spec.path(loaded.config).control_verdict(loaded, seed, 0.3, torch.device("cpu"))
        assert not v.correct and v.attempted > 0 and v.failed == v.attempted


def test_run_command_loads_nothing_of_jax_on_the_tick(tree):
    probe = ("import sys, torch; sys.path.insert(0, 'portbench'); import run; "
             "run.find_devices = lambda chips: torch.device('cpu'); "
             f"rc = run.main({args('tiny.tick', 1)!r}); "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tree, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "asciichat_tpu_torch" in loaded
    assert not loaded & FORBIDDEN_IN_RUN


NEW_PATH = '''
"""Frames one at a time through AsciiRenderer.convert, judged as convert_batch's."""
import contextlib

from harness import program, spec

base = spec.path({})
CALL = "convert_each"
SPANS = ()
control_verdict = base.control_verdict


class Bench(base.Bench):
    def __init__(self, cell, seed, device, mark):
        super().__init__(cell, seed, device, mark)
        types = program.load("asciichat_tpu_torch.render.types")
        conf, renderer = cell.config, self.renderer
        caps = types.TerminalCapabilities(types.ColorLevel[conf["color_level"]],
                                          types.RenderMode[conf["render_mode"]])
        self.call = lambda batch: [renderer.convert(f, conf["width"], conf["height"], caps)
                                   for f in batch.numpy()]

    @contextlib.contextmanager
    def installed(self, spans):
        yield
'''


def test_cell_on_a_path_of_new_files_only(tmp_path):
    """A configuration that names a path which is new files only runs through
    run.py, and the other cells read as they did."""
    tree = make_tree(tmp_path / "grown")
    before = {p: p.read_bytes() for p in (tree / "portbench").rglob("*") if p.is_file()}
    pb = tree / "portbench"
    (pb / "paths" / "convert_each.py").write_text(NEW_PATH)
    conf = json.loads((pb / "configs" / "truecolor-203x64.json").read_text())
    conf.update(name="each-40x12", path="convert_each", width=40, height=12)
    (pb / "configs" / "each-40x12.json").write_text(json.dumps(conf))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "each-40x12", "source": "tests", "reduced": [],
                             "why": "tests", "file": "portbench/configs/each-40x12.json"})
    bench["workloads"].append({"name": "each.tiny", "config": "each-40x12", "traffic": "tiny",
                               "chips": 1, "why": "tests"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, result, err = drive(tree, args("each.tiny", 1))
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert {n for n, _ in result["breakdown"]["idle_gaps"]} <= {"convert_each_other",
                                                                "between_calls"}
    rc, result, err = drive(tree, args("tiny.hb", 1))
    assert rc == 0 and result["correct"] and "emit_ms" in result["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


# The parent commit's run.py, before paths existed, on the tiny cells with
# seed 4000000007 and a window of one call (--seconds 0): what its result
# lines held apart from timings, and the yardstick's bytes a call. The
# truecolor cell's metrics are its own since its rate on the host left the
# end-to-end metrics (card_frames_per_s, which a CPU run cannot read, took
# its place, and host_frames_per_s took it per layer).
PARENT_METRICS = {0: ["frames_per_s", "setup_s"],
                  1: ["batch_p95_ms", "emit_copy_ms", "emit_gb_per_s", "emit_ms",
                      "emit_native_ms", "fetch_ms", "kernel_setup_s", "pipeline_other_ms"]}
PARENT_RUN = {
    "checks": {"frames_count_off": {"value": 0, "limit": 0},
               "frames_wrong_length": {"value": 0, "limit": 0},
               "sampled_frames_wrong": {"value": 0, "limit": 0}},
    "attempted": 4,
    "metrics": {"tiny.hb": PARENT_METRICS,
                "tiny.tc": {0: ["setup_s"], 1: ["host_frames_per_s", "kernel_setup_s"]}},
    "records_bytes": {"tiny.tc": 13440, "tiny.hb": 23040},
}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny.tc", "tiny.hb"])
def test_convert_batch_path_reads_as_the_parent_run(tree, cell, trace):
    rc, result, err = drive(tree, args(cell, trace, seconds=0, seed="4000000007"))
    assert rc == 0, err[-3000:]
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == PARENT_RUN["attempted"]
    assert result["checks"] == PARENT_RUN["checks"]
    assert sorted(result["metrics"]) == PARENT_RUN["metrics"][cell][trace]
    assert ("breakdown" in result) == bool(trace)


@pytest.mark.parametrize("cell", ["tiny.tc", "tiny.hb"])
def test_convert_batch_path_judges_and_counts_as_the_parent_run(tree, cell, monkeypatch):
    """The path's own set-up, call and judge in this process: the parent's
    checks and yardstick bytes."""
    import torch
    from harness import spec, window
    monkeypatch.setattr(spec, "BENCH_DIR", tree / "portbench")
    loaded = spec.load_cell(tree, cell, traced=False)
    bench = spec.path(loaded.config).Bench(loaded, 4000000007, torch.device("cpu"), print)
    win = window.run(bench.call, bench.states, 0, 4000000007, bench.store, bench.per_call,
                     bench.batch_size)
    bench.release()
    verdict, least = bench.judge(win, print)
    assert verdict.checks == PARENT_RUN["checks"] and verdict.attempted == 4
    assert least == PARENT_RUN["records_bytes"][cell]
