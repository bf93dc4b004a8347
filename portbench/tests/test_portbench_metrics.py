"""Each metric reader on a synthetic run: two calls, their spans, and a profile
with copies, kernels and the launches that tie kernels to their spans."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import REPO
from harness import spec, tracing
from harness.check import Verdict
from harness.record import Run, p95
from harness.window import SampleStore, Window
from harness.yardstick import HBM_BYTES_PER_S

MS = 1_000_000  # ns


def annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": tracing.PREFIX + name, "ts": ts,
            "dur": dur}


def device(cat, name, ts, dur, corr, nbytes=None):
    args = {"correlation": corr} | ({"bytes": nbytes} if nbytes else {})
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def synthetic_events():
    """Two calls of 10 ms (trace clock, us): to_device 0-4 ms, cells 4-5,
    fetch 5-6, emit 6-9.5; the copy 4 ms of device time moving 4e8 B; one
    kernel of 100 us launched inside cells_for_plan, one of 50 us launched
    inside emit_frames (not the records'); a fetch copy of 0.2 ms."""
    ev = []
    for k, t0 in enumerate((0.0, 10_000.0)):
        ev.append(annotation("convert_batch", t0, 10_000))
        ev.append(annotation("to_device", t0, 4_000))
        ev.append(annotation("cells_for_plan", t0 + 4_000, 1_000))
        ev.append(annotation("records_to_numpy", t0 + 5_000, 1_000))
        ev.append(annotation("emit_frames", t0 + 6_000, 3_500))
        ev.append(device("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t0 + 10, 4_000,
                         10 * k + 1, 400_000_000))
        ev.append(launch(t0 + 4_100, 10 * k + 2))
        ev.append(device("kernel", "records_kernel", t0 + 4_200, 100, 10 * k + 2))
        ev.append(launch(t0 + 6_100, 10 * k + 3))
        ev.append(device("kernel", "other_kernel", t0 + 6_200, 50, 10 * k + 3))
        ev.append(device("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t0 + 5_100, 200,
                         10 * k + 4, 1_000_000))
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "portbench.to_device",
                   "ts": t0, "dur": 9_000})  # not device work
    return ev


def synthetic_run(traced=True, call_ms=(10.0, 10.0)):
    calls, t = [], 0
    for ms in call_ms:
        calls.append((t, t + int(ms * MS)))
        t += int(ms * MS)
    spans = []
    for start, _ in calls:
        for name, a, b in (("to_device", 0, 4), ("cells_for_plan", 4, 5),
                           ("records_to_numpy", 5, 6), ("emit_frames", 6, 9.5)):
            spans.append((name, start + int(a * MS), start + int(b * MS)))
    win = Window(4, calls, [0, 1], [np.full(4, 100)] * len(calls), [], SampleStore(1, 1))
    trace = tracing.read_profile(synthetic_events(), spans) if traced else None
    cell = spec.Cell("t", 1, {}, {}, [])
    return Run(cell, 7.5, win, Verdict({}, 4 * len(calls), 1, 0), 33_500_000, trace)


def read(name, run):
    return spec.reader(name)(run)


def test_end_to_end_readers():
    run = synthetic_run(traced=False)
    assert read("frames_per_s", run) == pytest.approx(7 / 0.020)
    assert read("setup_s", run) == 7.5
    assert read("batch_p95_ms", run) == pytest.approx(10.0)


def test_span_readers():
    run = synthetic_run()
    assert read("fetch_ms", run) == pytest.approx(1.0)
    assert read("emit_ms", run) == pytest.approx(3.5)
    assert read("pipeline_other_ms", run) == pytest.approx(10.0 - 9.5)


def test_device_readers():
    run = synthetic_run()
    assert read("ingest_gb_per_s", run) == pytest.approx(2 * 4e8 / 0.008 / 1e9)
    # only the kernels launched inside cells_for_plan: 2 x 100 us
    want = 100 * 2 * 33_500_000 / HBM_BYTES_PER_S / 200e-6
    assert read("records_roofline", run) == pytest.approx(want)
    busy = 2 * (4_000 + 100 + 50 + 200)
    assert run.trace.busy_s == pytest.approx(busy / 1e6)
    assert run.trace.window_s == pytest.approx(0.020)
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - busy / 20_000))


def test_card_readers():
    run = synthetic_run()
    busy = 2 * (4_000 + 100 + 50 + 200) / 1e6
    assert read("card_frames_per_s", run) == pytest.approx(7 / busy)
    assert read("host_frames_per_s", run) == pytest.approx(7 / 0.020)
    assert read("card_ingest_gb_per_s", run) == read("ingest_gb_per_s", run)
    assert read("k2_roofline", run) == read("records_roofline", run)
    assert read("card_frames_per_s", synthetic_run(traced=False)) is None
    # a profile with nothing on a device (the CPU) gives no rate, never 0
    run.trace = tracing.read_profile(
        [e for e in synthetic_events() if e["cat"] == "user_annotation"], run.trace.spans)
    assert read("card_frames_per_s", run) is None


def test_idle_gaps_are_named_by_what_the_host_did():
    trace = synthetic_run().trace
    idle = trace.idle_by_activity()
    assert sum(idle.values()) == pytest.approx(trace.window_s - trace.busy_s)
    assert max(idle, key=idle.get) == "emit_frames"
    assert set(idle) <= {*spec.path({}).SPANS, "convert_batch_other", "between_calls"}
    bd = trace.breakdown()
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert bd["device_ops"][0][0].startswith("Memcpy HtoD")


def test_readers_find_nothing_untraced_and_report_nothing():
    run = synthetic_run(traced=False)
    for name in ("pipeline_other_ms", "ingest_gb_per_s", "records_roofline", "fetch_ms",
                 "emit_ms", "device_idle_pct"):
        assert read(name, run) is None


def test_a_kernel_without_its_launch_is_no_record_kernel():
    run = synthetic_run()
    run.trace = tracing.read_profile(
        [e for e in synthetic_events() if e["cat"] != "cuda_runtime"], run.trace.spans)
    assert read("records_roofline", run) is None


def test_p95_is_nearest_rank():
    assert p95(list(range(1, 101))) == 95
    assert p95([3.0]) == 3.0
    assert p95([]) is None
    assert read("batch_p95_ms", synthetic_run(call_ms=[1.0] * 19 + [9.0])) == 1.0


def test_every_metric_of_the_benchmark_has_a_reader_and_applies_somewhere():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert any(spec.applies(m, c, e2e) for c in cells), m["name"]
    for c in cells:
        assert spec.load_cell(REPO, c, traced=False).metrics
        assert spec.load_cell(REPO, c, traced=True).metrics


def test_each_cell_reports_the_metrics_its_per_layer_metrics_move():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        for c in cells:
            if spec.applies(m, c, e2e):
                assert spec.applies(e2e[m["moves"]], c, e2e), (m["name"], c)
    for c in cells:
        reported = {m["name"] for m in bench["end_to_end"] if spec.applies(m, c, e2e)}
        assert "setup_s" in reported and len(reported) >= 2, c
