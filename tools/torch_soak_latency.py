#!/usr/bin/env python
"""Latency/deadline soak of the PyTorch port's server: 3 production clients
at the 60 Hz serving cadence; asserts the steady-state p99 tick latency
under the 16.67 ms deadline.

The counterpart of tools/soak_latency.py, on ``asciichat_tpu_torch``: the
in-process server serves 3 REAL clients of the port, the warmup ticks are
excluded (every tracker reset after the warmup, the per-stage tracer too),
and the steady window's p50/p90/p99/worst tick latency (tick start through
emit + queue) and frame age (upload commit -> tick pickup) are printed as
one JSON line with the twin's keys plus the port's (tools/torch_soak_common
.port_keys) and RSS. It serves on the card unless
``ASCIICHAT_TORCH_DEVICE=cpu``.

Usage: python tools/torch_soak_latency.py [seconds] (defaults 60)
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_soak_common import (  # noqa: E402
    MemorySampler, boot_server, drift, drive_client, elide, lag_sampler, make_client,
    port_keys, stage_avg_ms, stop_server, warmup_reset,
)

WARMUP_FRACTION = 0.25


async def main(seconds: float) -> int:
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode

    server, tcp_srv, port, tick = await boot_server()
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + max(5.0, seconds * WARMUP_FRACTION)
    devnull = open(os.devnull, "wb")
    counts: dict[str, int] = {}
    failures: dict[str, str] = {}
    mem = MemorySampler(server.device, max(2.0, seconds / 30))
    loop_lag: dict = {}

    async def run_client(name):
        c = make_client(port, devnull, w=60, h=18,
                        color=ColorLevel.TRUECOLOR, mode=RenderMode.FOREGROUND)
        got, err = await drive_client(c, deadline)
        counts[name] = got
        if err:
            failures[name] = err

    t0 = time.monotonic()
    await asyncio.gather(
        run_client("c1"), run_client("c2"), run_client("c3"),
        mem.run(deadline),
        lag_sampler(deadline, warmup_until, loop_lag),
        warmup_reset(server, warmup_until),
    )
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)

    lat = server.tick_latency.stats_ms()
    age = server.frame_age.stats_ms()
    total = sum(counts.values())
    deadline_ms = server._tick_deadline * 1e3
    result = {
        "soak": f"latency_3client_60fps_{server.device.type}",
        "seconds": round(dt, 1),
        "clients": 3,
        "frames_delivered": total,
        "tick_rate": round(server.ticks / dt, 1),
        "latency_p50_ms": lat["p50_ms"],
        "latency_p90_ms": lat["p90_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "latency_samples": lat["n"],
        "frame_age_p50_ms": age["p50_ms"],
        "frame_age_p99_ms": age["p99_ms"],
        "deadline_ms": round(deadline_ms, 2),
        "stage_avg_ms": stage_avg_ms(server),
        "rss_start_kib": mem.rss0,
        "rss_peak_kib": max(mem.rss, default=mem.rss0),
        "rss_samples_kib": elide(mem.rss),
        "rss_postwarmup_drift_kib": round(drift(mem.rss)),
        **port_keys(server, mem, loop_lag),
    }
    ok = (not failures and tick_error is None and total > 0
          and lat["n"] > 50 and lat["p99_ms"] < deadline_ms)
    result["ok"] = ok
    if failures:
        result["died"] = failures
    if tick_error:
        result["server_tick_error"] = tick_error
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED (p99 {lat['p99_ms']} ms vs {deadline_ms:.2f} ms deadline, "
          f"died={failures}, tick_error={tick_error})")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
