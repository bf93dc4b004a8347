"""The traced run's spans and device profile.

Spans come from the benchmark's own wrappers around the calls that a path's
timed call makes (``paths/<path>.py``, its ``installed``; the program is not
edited): each records its host time and opens a ``torch.profiler`` range of
the same name, so the profile's device operations can be tied to the call
that launched them. The timed call itself is a range named by the path
(``CALL``). The profile covers the whole window; its trace is written to a
temporary file under ``TMPDIR``, read back and deleted.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

PREFIX = "portbench."
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Host spans of the wrapped calls: (name, start, end) in perf_counter_ns,
    within timed calls named ``call``."""

    def __init__(self, call: str):
        self.call = call
        self.events: list[tuple[str, int, int]] = []

    def wrap(self, name: str, fn):
        clock, events = time.perf_counter_ns, self.events
        label = PREFIX + name

        def wrapped(*args, **kwargs):
            start = clock()
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                events.append((name, start, clock()))
        return wrapped

    def call_scope(self):
        return torch.profiler.record_function(PREFIX + self.call)


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel, memcpy or memset
    start: float  # us, the trace's clock
    dur: float  # us
    bytes: int | None
    span: str | None  # the wrapped call that launched it; None where no launch was found


class Intervals:
    """Sorted, non-overlapping named intervals, looked up by a point."""

    def __init__(self, items: list[tuple[str, float, float]]):
        self.items = sorted(items, key=lambda it: it[1])
        self.starts = [it[1] for it in self.items]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.items[i][2]:
            return self.items[i][0]
        return None


@dataclasses.dataclass
class Trace:
    spans: list[tuple[str, int, int]]  # host clock, from Spans
    ops: list[DeviceOp]  # device operations inside the window
    window: tuple[float, float]  # us: first call's start to last call's end
    calls: Intervals  # the profiler's ranges of the timed calls
    inner: Intervals  # the profiler's ranges of the wrapped calls
    call: str = "convert_batch"  # the timed call's name

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        merged: list[list[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            a, b = max(lo, op.start), min(hi, op.start + op.dur)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def host_activity(self, t: float) -> str:
        """What the host was doing at ``t``: a wrapped call, the rest of the
        timed call (``<call>_other``), or nothing of the window's calls."""
        return self.inner.at(t) or (f"{self.call}_other" if self.calls.at(t) else "between_calls")

    def idle_by_activity(self) -> dict[str, float]:
        """Seconds of the window with nothing on the device, by host activity
        at the middle of each idle gap."""
        out: dict[str, float] = defaultdict(float)
        edge = self.window[0]
        for a, b in [*self.busy_intervals(), (self.window[1], self.window[1])]:
            if a > edge:
                out[self.host_activity((edge + a) / 2)] += (a - edge) / 1e6
            edge = max(edge, b)
        return dict(out)

    def device_time_by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for op in self.ops:
            out[op.name] += op.dur / 1e6
        return dict(out)

    def breakdown(self) -> dict:
        def top(d: dict[str, float]) -> list:
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.device_time_by_name()),
                "idle_gaps": top(self.idle_by_activity())}


def read_profile(events: list[dict], spans: list[tuple[str, int, int]],
                 call: str = "convert_batch") -> Trace:
    """The Trace of a Chrome trace's ``traceEvents``, whose timed calls are
    the ranges named ``call``."""
    launches: dict[int, float] = {}
    ranges: dict[str, list[tuple[str, float, float]]] = {call: [], "inner": []}
    raw: list[dict] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_KINDS:
            raw.append(ev)
        elif cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = float(ev["ts"])
        elif cat == "user_annotation" and name.startswith(PREFIX):
            item = (name[len(PREFIX):], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            ranges[call if item[0] == call else "inner"].append(item)
    calls, inner = Intervals(ranges[call]), Intervals(ranges["inner"])
    window = ((calls.items[0][1], max(c[2] for c in calls.items)) if calls.items else (0.0, 0.0))
    ops = []
    for ev in raw:
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if start + dur < window[0] or start > window[1]:
            continue
        args = ev.get("args", {})
        launched = launches.get(args.get("correlation"))
        span = None if launched is None else inner.at(launched) or calls.at(launched)
        ops.append(DeviceOp(ev["name"], DEVICE_KINDS[ev["cat"]], start, dur,
                            args.get("bytes"), span))
    return Trace(spans, ops, window, calls, inner, call)


class Profile:
    """A torch.profiler window over the device (and the host's ranges)."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self) -> list[dict]:
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            print(f"portbench: profile written: {os.path.getsize(path)} bytes", file=sys.stderr,
                  flush=True)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
