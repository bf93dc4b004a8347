#!/usr/bin/env python3
"""Where the overlapped pipeline's fetch stage spends its time on one card.

    python3 tools/pipeline_fetch.py

``bench``'s pipeline (``runtime/device_stream.OverlappedRenderPipeline``)
fetches 8 frames' truecolor records (370 KB) a step: pinned buffers, a
``non_blocking`` copy on its own stream, an event it waits on. This times
those four parts on the host clock (200 fetches each, median and p90, ms)
with the card idle, and then while another thread keeps the card busy the
way the pipeline's convert stage does: a CUDA graph of 24 K2 launches at 128
x 1080p -> 57x203, two in flight, alone ("graph only", the bench's step)
and followed by one eager ``render_cells`` call ("graph + eager"). Then the
pipeline itself runs 3 s with each of those two steps. The last line of
standard output is one JSON object; the card's name and power limit come
first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from asciichat_tpu_torch.apps import bench  # noqa: E402
from asciichat_tpu_torch.ops import cells  # noqa: E402
from asciichat_tpu_torch.render import emitter  # noqa: E402
from asciichat_tpu_torch.render import palette as pal  # noqa: E402
from asciichat_tpu_torch.render.pipeline import plan_render  # noqa: E402
from asciichat_tpu_torch.runtime.device import require_cuda  # noqa: E402
from asciichat_tpu_torch.runtime.device_stream import OverlappedRenderPipeline  # noqa: E402

FETCHES = 200
PARTS = ("alloc", "copy_issue", "record", "wait")


def main() -> int:
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    plan = plan_render(1920, 1080, bench.TERM_W, bench.TERM_H, bench.FG_TRUECOLOR)
    frames = bench.make_frames(128, 1080, 1920, dev)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    tables = cells.cell_tables(1080, 1920, plan.dst_h_px, plan.dst_w, dev)

    def convert(f=frames, r=ramp):
        return cells.render_cells(f, r, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode,
                                  tables=tables)

    recs = convert()
    graph = bench.loop(convert, bench.PIPELINE_K, True)
    fetch_stream = torch.cuda.Stream()
    n = bench.FETCH_SLICE

    def fetch() -> list[float]:
        t = [time.perf_counter()]
        with torch.cuda.stream(fetch_stream):
            pinned = {}
            for k, v in recs.items():
                v[:n].record_stream(fetch_stream)
                pinned[k] = torch.empty(v[:n].shape, dtype=v.dtype, pin_memory=True)
            t.append(time.perf_counter())
            for k, v in recs.items():
                pinned[k].copy_(v[:n], non_blocking=True)
            t.append(time.perf_counter())
            done = torch.cuda.Event()
            done.record(fetch_stream)
            t.append(time.perf_counter())
            done.synchronize()
            t.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    def busy(stop: threading.Event, eager: bool) -> None:
        torch.cuda.set_device(dev)
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            inflight = []
            while not stop.is_set():
                graph()
                if eager:
                    convert()
                done = torch.cuda.Event()
                done.record(stream)
                inflight.append(done)
                if len(inflight) >= 2:
                    inflight.pop(0).synchronize()

    report = {"card": card, "fetch_ms": {}, "pipeline": {}}
    for label, eager in (("idle", None), ("graph only", False), ("graph + eager", True)):
        stop = threading.Event()
        worker = None
        if eager is not None:
            worker = threading.Thread(target=busy, args=(stop, eager), daemon=True)
            worker.start()
            time.sleep(0.5)
        rows = np.array([fetch() for _ in range(FETCHES)])
        if worker is not None:
            stop.set()
            worker.join(timeout=30)
        med, p90 = np.median(rows, 0), np.percentile(rows, 90, 0)
        report["fetch_ms"][label] = {p: {"median": float(m), "p90": float(q)}
                                     for p, m, q in zip(PARTS, med, p90)}
        print(f"{label}: fetch of {n} frames, ms median "
              + ", ".join(f"{p} {m:.4f}" for p, m in zip(PARTS, med))
              + f"; total {med.sum():.4f} [{card}]", flush=True)

    def emit(host):
        return emitter.emit_frames(host, plan.mode, pal.DEFAULT_PALETTE, pad_w=plan.pad_w,
                                   pad_h=plan.pad_h, nthreads=1, copy=False)

    def graph_only(f, r):  # the bench's step: a copy of the graph's records
        return {k: v.clone() for k, v in graph().items()}

    def graph_and_eager(f, r):  # fresh records from one more, eager, conversion
        graph()
        return convert(f, r)

    steps = {"graph only": (graph_only, bench.PIPELINE_K),
             "graph + eager": (graph_and_eager, bench.PIPELINE_K + 1)}
    for label, (step, k) in steps.items():
        pipe = OverlappedRenderPipeline(step, frames, ramp, emit, batch=128, k=k,
                                        fetch_slice=n)
        rates = pipe.run(seconds=3.0, warmup=1.0)
        report["pipeline"][label] = rates
        print(f"pipeline, {label} step: convert {rates['convert_fps']:,.0f} fps, d2h "
              f"{rates['d2h_fps']:,.0f} fps, emit {rates['emit_fps']:,.0f} fps [{card}]",
              flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
