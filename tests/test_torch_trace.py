"""The port's tracer (asciichat_tpu_torch/utils/trace.py): spans inside the
render path and the server's ticks, their records and profiler ranges under
torch.profiler, the always-on aggregates and counters, and the whole-run
latency histogram."""

from __future__ import annotations

import json
import random
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.apps import server as tserver
from asciichat_tpu_torch.net import protocol as tproto
from asciichat_tpu_torch.ops import audio as taudio
from asciichat_tpu_torch.render import emitter
from asciichat_tpu_torch.render.pipeline import AsciiRenderer
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime import kernel_build
from asciichat_tpu_torch.utils import trace

from conftest import synthetic_frame

CPU = torch.device("cpu")
MODES = {"truecolor": TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND),
         "halfblock": TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)}
# The stages of convert_batch on the CPU (no render.fetch.sync: nothing to wait for).
CPU_STAGES = {"render.convert_batch", "render.ingest", "render.plan", "render.records",
              "render.fetch", "render.emit", "render.emit.native", "render.emit.copy"}
PARENTS = {"render.ingest": "render.convert_batch", "render.plan": "render.convert_batch",
           "render.records": "render.convert_batch", "render.fetch": "render.convert_batch",
           "render.emit": "render.convert_batch", "render.emit.native": "render.emit",
           "render.emit.copy": "render.emit"}


@pytest.fixture(autouse=True)
def emitter_loaded():
    """The emitter's library loaded before a test counts spans."""
    kernel_build.emitter_lib()


def batch(n: int = 3) -> np.ndarray:
    return np.stack([synthetic_frame(48, 64, seed=i) for i in range(n)])


def convert(frames, mode: str = "truecolor") -> list[bytes]:
    return AsciiRenderer(device=CPU).convert_batch(frames, 40, 12, MODES[mode])


def since(t0: int) -> list[trace.SpanRecord]:
    return [r for r in trace.records() if r.start_ns >= t0]


def profiled(fn, path) -> tuple[object, list[trace.SpanRecord], list[dict]]:
    """``fn()`` under torch.profiler (CPU): its result, the span records it
    left and the trace's ``asciichat.*`` ranges."""
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith(trace.RANGE_PREFIX)]
    return out, since(t0), ranges


def test_spans_lie_on_the_profilers_ranges(tmp_path):
    """Under torch.profiler every span record has an ``asciichat.<name>``
    range of the same name and nesting, and one offset fitted from the pairs
    puts every span within 0.5 ms of its range."""
    frames = batch()
    out, recs, ranges = profiled(lambda: [convert(frames), convert(frames)],
                                 tmp_path / "trace.json")
    assert {r.name for r in recs} == CPU_STAGES
    assert len(recs) == 2 * len(CPU_STAGES)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "render.convert_batch":
            assert r.parent is None or r.parent not in by_id
        else:
            assert by_id[r.parent].name == PARENTS[r.name]
            assert r.request == by_id[r.parent].request
            assert by_id[r.parent].start_ns <= r.start_ns <= r.end_ns <= by_id[r.parent].end_ns
    assert len({r.request for r in recs}) == 2  # one request a call

    pairs = []
    for name in CPU_STAGES:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.start_ns)
        theirs = sorted((e for e in ranges if e["name"] == trace.RANGE_PREFIX + name),
                        key=lambda e: e["ts"])
        assert len(mine) == len(theirs) == 2, name
        pairs += zip(mine, theirs)
    offset = statistics.median(float(e["ts"]) - r.start_ns / 1e3 for r, e in pairs)
    for r, e in pairs:
        assert abs(r.start_ns / 1e3 + offset - float(e["ts"])) < 500.0, r.name
        assert abs(r.end_ns / 1e3 + offset - float(e["ts"]) - float(e["dur"])) < 500.0, r.name
    # the ranges nest as the records do
    span_of = {id(r): e for r, e in pairs}
    for r, e in pairs:
        if r.parent in by_id:
            p = span_of[id(by_id[r.parent])]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"], r.name
    # the records' counts: the bytes ingested and emitted
    for call, frames_out in enumerate(out):
        ingest = [r for r in recs if r.name == "render.ingest"][call]
        native = [r for r in recs if r.name == "render.emit.native"][call]
        assert ingest.counts == {"bytes": frames.nbytes, "ingest_whole_batches": 1}
        assert native.counts["ansi_bytes"] == sum(map(len, frames_out))


def test_no_profiler_keeps_no_record_and_opens_no_range(monkeypatch):
    """With no profiler recording, convert_batch keeps no span record and
    never enters record_function, while the aggregates and counters count."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    frames = batch()
    before = trace.PROCESS.snapshot()
    counters = trace.PROCESS.counters()
    t0 = time.perf_counter_ns()
    for _ in range(2):
        convert(frames)
    assert since(t0) == []
    after = trace.PROCESS.snapshot()
    for name in CPU_STAGES:
        assert after[name][1] - before.get(name, (0.0, 0))[1] == 2, name
        assert after[name][0] > before.get(name, (0.0, 0))[0], name
    got = trace.PROCESS.counters()
    assert got["render.ingest.bytes"] - counters.get("render.ingest.bytes", 0) == 2 * frames.nbytes


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ansi_bytes_count_the_frames_returned(mode):
    """``ansi_bytes`` adds up the lengths of the frames emitted."""
    frames = batch(4)
    key = "render.emit.native.ansi_bytes"
    before = trace.PROCESS.counters().get(key, 0)
    out = convert(frames, mode)
    assert trace.PROCESS.counters()[key] - before == sum(map(len, out))


def test_emit_without_copy_has_no_copy_span(tmp_path):
    """emit_frames(copy=False), as the server calls it, has a native span
    and no copy span."""
    rec = {"rgb": np.zeros((2, 3, 4, 3), np.uint8), "luma": np.zeros((2, 3, 4), np.uint8)}
    views, recs, _ = profiled(lambda: emitter.emit_frames(rec, "truecolor_fg", copy=False),
                              tmp_path / "trace.json")
    assert sorted(r.name for r in recs) == ["render.emit", "render.emit.native"]
    native = next(r for r in recs if r.name == "render.emit.native")
    assert native.counts["ansi_bytes"] == sum(len(v) for v in views)


@pytest.mark.parametrize("mode", ["16color_dithered", "16color_dithered_bg", "truecolor_fg"])
def test_dithered_cells_count_the_cells_dithered(mode, tmp_path):
    """The Floyd-Steinberg modes count B*H*W ``dithered_cells`` on their
    native span; other modes count none."""
    rng = np.random.default_rng(5)
    rec = {"rgb": rng.integers(0, 256, (2, 3, 5, 3), dtype=np.uint8),
           "luma": rng.integers(0, 256, (2, 3, 5), dtype=np.uint8)}
    key = "render.emit.native.dithered_cells"
    before = trace.PROCESS.counters().get(key, 0)
    _, recs, _ = profiled(lambda: emitter.emit_frames(rec, mode), tmp_path / "trace.json")
    native = next(r for r in recs if r.name == "render.emit.native")
    if mode == "truecolor_fg":
        assert "dithered_cells" not in native.counts
        assert trace.PROCESS.counters().get(key, 0) == before
    else:
        assert native.counts["dithered_cells"] == 2 * 3 * 5
        assert trace.PROCESS.counters()[key] - before == 2 * 3 * 5


def test_kernel_build_and_load_spans(monkeypatch, tmp_path):
    """A native library built afresh is one ``kernel.build`` span counting a
    library, and its digest and load are ``kernel.load`` spans."""
    monkeypatch.setattr(kernel_build, "NATIVE_BUILD_DIR", tmp_path)
    before = trace.PROCESS.snapshot()
    built = trace.PROCESS.counters().get("kernel.build.libraries", 0)

    def n(snap, name):
        return snap.get(name, (0.0, 0))[1]

    kernel_build.native_lib.__wrapped__("ringbuffer")
    mid = trace.PROCESS.snapshot()
    assert n(mid, "kernel.build") - n(before, "kernel.build") == 1
    assert n(mid, "kernel.load") - n(before, "kernel.load") == 2
    assert trace.PROCESS.counters()["kernel.build.libraries"] - built == 1
    kernel_build.native_lib.__wrapped__("ringbuffer")  # found: loaded, not built
    after = trace.PROCESS.snapshot()
    assert n(after, "kernel.build") == n(mid, "kernel.build")
    assert n(after, "kernel.load") - n(mid, "kernel.load") == 2


def test_spans_nest_per_thread_and_aggregates_lose_no_update():
    """A span opened in one thread is never the parent of another thread's,
    and concurrent spans and counters of one tracer all count."""
    tracer = trace.Tracer("stress")
    threads_n, per_thread = 16, 400
    parents: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tracer.span("outer"):
            def work():
                for _ in range(per_thread):
                    with tracer.span("inner") as sp:
                        sp.add("items", 2)
                        parents.append(trace._CURRENT.get().parent)
            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracer.snapshot()
    assert snap["inner"][1] == threads_n * per_thread and snap["outer"][1] == 1
    assert tracer.counters() == {"inner.items": 2 * threads_n * per_thread}
    assert set(parents) == {None}
    line = tracer.breakdown()
    assert line.startswith("STRESS_BREAKDOWN: ") and "inner=" in line and "outer=" in line
    tracer.reset()
    assert tracer.snapshot() == {} and tracer.counters() == {} and tracer.breakdown() is None


def test_histogram_percentiles_within_one_percent():
    """Every percentile of the log-bucketed histogram is within 1% of the
    nearest-rank percentile of the samples."""
    rng = random.Random(7)
    values = [rng.lognormvariate(14.0, 2.0) for _ in range(20_000)]
    hist = trace.Histogram()
    for v in values:
        hist.add(v)
    ordered = sorted(values)
    for q in (0, 1, 10, 50, 90, 99, 99.9, 100):
        want = ordered[min(len(ordered) - 1, int(q / 100 * len(ordered)))]
        assert hist.percentile(q) == pytest.approx(want, rel=0.01), q
    assert hist.count == len(values) and hist.worst == max(values)
    assert hist.total == pytest.approx(sum(values))


def test_latency_tracker_covers_the_whole_run():
    """10,000 ticks whose first 100 are a slow stretch (50 ms, one of them
    250 ms), then 9,900 at 5 ms: p99 and the worst still see the stretch,
    which a window of the last 2,048 samples would drop."""
    lat = trace.LatencyTracker()
    for i in range(100):
        lat.add(0.250 if i == 42 else 0.050)
    for _ in range(9_900):
        lat.add(0.005)
    p50, p99 = lat.percentile(50, 99)
    assert p50 == pytest.approx(0.005, rel=0.01)
    assert p99 == pytest.approx(0.050, rel=0.01)
    assert lat.worst == 0.250 and lat.count == 10_000
    stats = lat.stats_ms()
    assert stats["n"] == 10_000 and stats["worst_ms"] == 250.0
    assert stats["p99_ms"] == pytest.approx(50.0, rel=0.01)
    lat.reset()
    assert lat.count == 0 and lat.stats_ms()["p99_ms"] == 0.0


class FakeTransport:
    """Captures server->client sends."""

    def __init__(self):
        self.sent: list[tuple[int, bytes]] = []
        self.peername = ("127.0.0.1", 0)

    def send_nowait(self, ptype, payload: bytes = b"", **kw) -> bool:
        self.sent.append((int(ptype), bytes(payload)))
        return True


def test_server_ticks_report_every_stage(monkeypatch, tmp_path):
    """One video tick and one audio tick on the CPU: the inspector's state
    holds every stage of each (``fill`` and ``device_render`` among the
    video's, ``drain``, ``mix`` and ``encode_send`` the audio's) and the
    process's counters; under torch.profiler the emitter's native span nests
    under the tick's ``emit`` stage, all one request."""
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ASCIICHAT_FORCE_MESH", "")
    srv = tserver.AsciiChatServer()
    clients = []
    for i in range(2):
        c = tserver.ClientState(i + 1, FakeTransport())
        c.wire_caps = tproto.WireCapabilities(width=40, height=12)
        c.has_caps = True
        c.video.commit(synthetic_frame(48, 64, seed=i))
        c.streaming = True
        c.audio.write(np.full(taudio.AUDIO_FRAME_SAMPLES, 0.01 * (i + 1), np.float32))
        clients.append(c)

    def ticks():
        srv._render_tick(clients)
        srv._audio_tick(clients)

    _, recs, ranges = profiled(ticks, tmp_path / "trace.json")
    assert srv.device_failures == 0
    assert all(len(c.transport.sent) == 2 for c in clients)  # a frame and a mix each
    state = srv.server_state()
    assert set(state["tick_stages_ms"]) == {"fill", "upload", "convert", "device_render",
                                            "fetch", "emit", "pack", "send"}
    assert set(state["audio_stages_ms"]) == {"drain", "mix", "encode_send"}
    assert state["trace_counters"]["render.emit.native.ansi_bytes"] > 0

    by_id = {r.id: r for r in recs}
    native = next(r for r in recs if r.name == "render.emit.native")
    emit = by_id[native.parent]
    assert emit.name == "render.emit" and by_id[emit.parent].name == "tick.emit"
    tick = next(r for r in recs if r.name == "server.tick")
    video = {r.name for r in recs if r.request == tick.request}
    assert {"tick.fill", "tick.convert", "tick.fetch", "render.emit.native"} <= video
    audio_tick = next(r for r in recs if r.name == "server.audio_tick")
    assert {r.name for r in recs if r.request == audio_tick.request} == {
        "server.audio_tick", "audio.drain", "audio.mix", "audio.encode_send"}
    assert {e["name"] for e in ranges} >= {"asciichat.tick.fill", "asciichat.audio.mix"}
