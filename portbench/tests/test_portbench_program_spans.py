"""The readers of the program's own spans, and the clock fit that maps them
onto the device trace, on a synthetic run whose two clocks differ by a known
offset."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest

from conftest import REPO
from harness import program_spans, spec, tracing
from harness.check import Verdict
from harness.record import Run
from harness.window import SampleStore, Window

MS = 1_000_000  # ns
HOST0 = 5_000 * MS  # the window's first call on perf_counter_ns
OFFSET_US = -4_321_987.5  # trace clock (us) = perf_counter_ns / 1e3 + OFFSET_US
# jitter of the profiler's range starts against the spans' starts (us)
JITTER_US = {("to_device", 0): 30.0, ("emit_frames", 1): -20.0, ("cells_for_plan", 1): 2.0}
STAGES = (("to_device", 0, 4), ("cells_for_plan", 4, 5), ("records_to_numpy", 5, 6),
          ("emit_frames", 6, 9.5))


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    counts: dict


def us(ns: int) -> float:
    return ns / 1e3 + OFFSET_US


def profile_events():
    """The benchmark's ranges on the trace's clock; per call a 4 ms upload,
    a 0.1 ms kernel launched in cells_for_plan and a 0.2 ms fetch copy."""
    ev = []
    for k in range(2):
        t0 = HOST0 + k * 10 * MS
        ev.append({"ph": "X", "cat": "user_annotation", "name": tracing.PREFIX + "convert_batch",
                   "ts": us(t0), "dur": 10_000.0})
        for name, a, b in STAGES:
            ev.append({"ph": "X", "cat": "user_annotation", "name": tracing.PREFIX + name,
                       "ts": us(t0 + int(a * MS)) + JITTER_US.get((name, k), 0.0),
                       "dur": (b - a) * 1e3})
        for cat, name, a, dur in (("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 0.01, 4_000),
                                  ("kernel", "records_kernel", 4.2, 100),
                                  ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 5.1, 200)):
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": us(t0 + int(a * MS)),
                       "dur": float(dur), "args": {"correlation": 10 * k + len(ev)}})
    return ev


def program_records():
    """The program's spans of the two calls, on perf_counter_ns: emit 6.05-
    9.45 ms of a call, native 6.1-8.1 (1e7 ANSI bytes), copy 8.1-9.4; a
    kernel load inside the window (50 ms); a span of another name."""
    recs = []
    for k in range(2):
        t0 = HOST0 + k * 10 * MS
        recs += [Record("render.emit", t0 + int(6.05 * MS), t0 + int(9.45 * MS), {}),
                 Record("render.emit.native", t0 + int(6.1 * MS), t0 + int(8.1 * MS),
                        {"ansi_bytes": 10_000_000}),
                 Record("render.emit.copy", t0 + int(8.1 * MS), t0 + int(9.4 * MS), {}),
                 Record("render.fetch", t0 + 5 * MS, t0 + 6 * MS, {})]
    recs.append(Record("kernel.load", HOST0 + 12 * MS, HOST0 + 62 * MS, {}))
    # before the window: not the window's
    recs.append(Record("render.emit", HOST0 - 20 * MS, HOST0 - 10 * MS, {}))
    return recs


def synthetic_run(traced: bool = True) -> Run:
    calls = [(HOST0 + k * 10 * MS, HOST0 + (k + 1) * 10 * MS) for k in range(2)]
    spans = [(name, start + int(a * MS), start + int(b * MS))
             for start, _ in calls for name, a, b in STAGES]
    win = Window(4, calls, [0, 1], [np.full(4, 100)] * 2, [], SampleStore(1, 1))
    trace = tracing.read_profile(profile_events(), spans) if traced else None
    return Run(spec.Cell("t", 1, {}, {}, []), 9.0, win, Verdict({}, 8, 1, 0), 1, trace)


@pytest.fixture
def program(monkeypatch):
    """A program module that keeps span records and process totals."""
    snap = {"kernel.build": (12.0, 1), "kernel.load": (0.55, 4), "render.emit": (1.0, 9)}
    mod = SimpleNamespace(records=program_records,
                          PROCESS=SimpleNamespace(snapshot=lambda: dict(snap)))
    monkeypatch.setitem(sys.modules, program_spans.MODULE, mod)
    return mod


def read(name, run):
    return spec.reader(name)(run)


def test_clock_fit_finds_the_offset_and_its_spread(program, capsys):
    run = synthetic_run()
    fit = program_spans.clock_fit(run)
    assert fit.pairs == 8
    assert fit.offset_us == pytest.approx(OFFSET_US, abs=1.0)
    assert fit.worst_us == pytest.approx(30.0, abs=1.0)
    assert 0.0 <= fit.spread_us < 30.0
    assert program_spans.clock_fit(run) is fit
    assert capsys.readouterr().err.count("clock offset") == 1


def test_program_span_readers(program):
    run = synthetic_run()
    assert read("emit_native_ms", run) == pytest.approx(2.0)
    assert read("emit_copy_ms", run) == pytest.approx(1.3)
    assert read("emit_gb_per_s", run) == pytest.approx(2e7 / 0.004 / 1e9)
    # the emits (3.4 ms a call) lie wholly in the device's idle stretches
    assert read("idle_in_emit_pct", run) == pytest.approx(100 * 6.8 / 20.0, abs=0.01)
    # the set-up totals less the load inside the window
    assert read("kernel_setup_s", run) == pytest.approx(12.0 + 0.55 - 0.05)


def test_idle_in_emit_counts_only_idle_time(program, monkeypatch):
    """A copy on the card inside the emits is taken off their idle time."""
    events = profile_events()
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                   "ts": us(HOST0 + 7 * MS), "dur": 1_000.0, "args": {"correlation": 999}})
    run = synthetic_run()
    run.trace = tracing.read_profile(events, run.trace.spans)
    assert read("idle_in_emit_pct", run) == pytest.approx(100 * 5.8 / 20.0, abs=0.01)


def test_readers_find_nothing_in_a_program_without_records(monkeypatch):
    """The parent's program keeps no records: every reader gives None."""
    monkeypatch.setitem(sys.modules, program_spans.MODULE, SimpleNamespace(Tracer=object))
    run = synthetic_run()
    for name in ("emit_native_ms", "emit_copy_ms", "emit_gb_per_s", "idle_in_emit_pct",
                 "kernel_setup_s"):
        assert read(name, run) is None, name
    monkeypatch.delitem(sys.modules, program_spans.MODULE)
    assert read("kernel_setup_s", run) is None


def test_readers_find_nothing_untraced(program):
    run = synthetic_run(traced=False)
    for name in ("emit_native_ms", "emit_copy_ms", "emit_gb_per_s", "idle_in_emit_pct"):
        assert read(name, run) is None, name


def test_overlap_of_interval_lists():
    assert program_spans.overlap_us([(0, 2), (5, 9)], [(1, 6), (8, 20)]) == 1 + 1 + 1
    assert program_spans.overlap_us([], [(0, 1)]) == 0.0


def test_idle_split_tool_on_a_tiny_cell(tree, tmp_path):
    """tools/portbench_idle_split.py on a tiny traced cell (CPU: the whole
    window is idle): its parts sum to the window's idle time, and the run's
    result line is the benchmark's."""
    (tree / "tools").mkdir(exist_ok=True)
    shutil.copy(REPO / "tools" / "portbench_idle_split.py", tree / "tools")
    out = tmp_path / "split.json"
    probe = ("import sys, torch; sys.path.insert(0, 'tools'); import portbench_idle_split as t; "
             "t.run.find_devices = lambda chips: torch.device('cpu'); "
             "sys.exit(t.main(sys.argv[1:]))")
    args = ["--workload", "tiny.tc", "--seed", "4170000301", "--seconds", "0.5", "--trace", "1"]
    proc = subprocess.run([sys.executable, "-c", probe, str(out), *args], cwd=tree,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
    split = json.loads(out.read_text())
    idle = split["window_s"] - split["busy_s"]
    assert sum(split["idle_s_by_innermost_span"].values()) == pytest.approx(idle, rel=1e-6)
    assert {"render.emit.native", "render.emit.copy"} <= set(split["idle_s_by_innermost_span"])
