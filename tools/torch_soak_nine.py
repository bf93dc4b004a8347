#!/usr/bin/env python
"""9-client heterogeneous soak of the PyTorch port's server, with join/leave
churn and live resizes.

The counterpart of tools/soak_nine.py, on ``asciichat_tpu_torch``: 9
PRODUCTION clients of the port in one live server tick, over 4 render
groups (100x30 and 80x24 truecolor, 203x64 256-colour, 100x30 with a custom
palette) and 6 distinct colour filters, plus a churn client that joins and
leaves throughout and a client that resizes every ~20 s. Every join, leave
and resize changes the source layout: on the card each builds a new
``RenderGroup`` with its device maps, and every tick renders all groups in
one K3 launch (``models/server.render_groups``). It serves on the card
unless ``ASCIICHAT_TORCH_DEVICE=cpu``.

One JSON line (docs/artifacts/soak_nine_torch_r*.json) with the twin's keys:
per-client delivery and balance, tick cadence (wall and steady), group
rebuilds and layout replans, steady tick latency against the 16.67 ms
deadline, the loop lag and stage split, RSS samples and drift; plus the
port's (tools/torch_soak_common.port_keys): the card, the device-memory
samples and drift, the kernels' launches, failed device ticks. The gates
are the twin's: liveness (no death, balance > 0.5, >= 3 churn cycles, >= 2
replans a cycle, no RSS slope) and cadence (>= 59.4 steady ticks/s and p99
< 16.67 ms).

Usage: python tools/torch_soak_nine.py [seconds] (defaults 600)
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
    port_keys, stage_avg_ms, stop_server, uplink_fps, warmup_reset,
)


def specs():
    """The 9 persistent clients (soak_nine.py's SPECS): name, w, h, colour,
    mode, palette, filter."""
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode

    return [
        ("a1", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, "", "none"),
        ("a2", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, "", "green"),
        ("a3", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, "", "rainbow"),
        ("b1", 80, 24, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, "", "cyan"),
        ("b2", 80, 24, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, "", "magenta"),
        ("c1", 203, 64, ColorLevel.COLOR_256, RenderMode.HALF_BLOCK, "", "none"),
        ("c2", 203, 64, ColorLevel.COLOR_256, RenderMode.HALF_BLOCK, "", "orange"),
        ("d1", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, " .:#@", "none"),
        ("d2", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, " .:#@", "red"),
    ]


async def main(seconds: float) -> int:
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode

    server, tcp_srv, port, tick = await boot_server()
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + min(60.0, seconds * 0.25)
    devnull = open(os.devnull, "wb")
    counts: dict[str, int] = {}
    failures: dict[str, str] = {}
    churn_events = 0
    live: dict[str, object] = {}  # name -> running client (resize churn)

    async def run_client(name, spec, until):
        w, h, color, mode, palette, filt = spec
        c = make_client(port, devnull, w=w, h=h, color=color, mode=mode,
                        palette=palette, filt=filt)
        live[name] = c
        try:
            got, err = await drive_client(c, until)
        finally:
            live.pop(name, None)
        counts[name] = counts.get(name, 0) + got
        if err:
            failures[f"{name}#{len(failures)}"] = err
        return err is None and got > 0

    async def churner():
        # a 10th client with its own geometry streams ~15 s, leaves ~10 s
        nonlocal churn_events
        spec = (90, 28, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, "", "teal")
        while time.monotonic() + 20 < deadline:
            ok = await run_client("churn", spec,
                                  min(deadline, time.monotonic() + 15))
            if ok:  # only a cycle that actually streamed counts
                churn_events += 1
            await asyncio.sleep(10)

    resize_events = 0

    async def resizer():
        # every ~20 s one persistent client flips between two group keys
        nonlocal resize_events
        dims = [(80, 24), (100, 30)]
        while time.monotonic() + 15 < deadline:
            await asyncio.sleep(20)
            c = live.get("a1")
            if c is not None:
                c.request_resize(*dims[resize_events % 2])
                resize_events += 1

    mem = MemorySampler(server.device, max(5.0, seconds / 40))
    loop_lag: dict = {}
    t0 = time.monotonic()
    results = await asyncio.gather(
        *(run_client(name, spec, deadline) for name, *spec in specs()),
        churner(),
        resizer(),
        mem.run(deadline),
        lag_sampler(deadline, warmup_until, loop_lag),
        warmup_reset(server, warmup_until),
    )
    ticks_w, t_w = results[-1]  # steady-state window start (warmup_reset)
    steady_dt = time.monotonic() - t_w
    steady_ticks = server.ticks - ticks_w
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)

    nums = [v for k, v in counts.items() if k != "churn"]
    total = sum(counts.values())
    balance = (min(nums) / max(nums)) if nums and max(nums) > 0 else 0.0
    samples = mem.rss
    rss_drift = drift(samples)
    lat = server.tick_latency.stats_ms()
    postwarm = samples[2:] if len(samples) > 4 else samples
    result = {
        "soak": f"nine_heterogeneous_churn_{server.device.type}",
        "seconds": round(dt, 1),
        "uplink_fps": uplink_fps(),
        "clients": 9,
        "render_groups_concurrent": 4,
        "distinct_filters": 6,
        "frames_delivered": total,
        "per_client": counts,
        "balance_min_over_max": round(balance, 3),
        "churn_joins": churn_events,
        "live_resizes": resize_events,
        "group_rebuilds": server.group_creates,
        "tick_rate": round(server.ticks / dt, 1),
        "tick_rate_steady": round(steady_ticks / steady_dt, 2),
        "ticks": server.ticks,
        "ticks_steady": steady_ticks,
        "layout_replans": server.layout_replans,
        "device_tick_computes": server.tick_compute_count,
        "latency_p50_ms": lat["p50_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "latency_samples": lat["n"],
        "deadline_ms": 16.67,
        "stage_avg_ms": stage_avg_ms(server),
        "rss_start_kib": mem.rss0,
        "rss_peak_kib": max(samples, default=mem.rss0),
        "rss_peak_postwarmup_kib": max(postwarm, default=mem.rss0),
        "rss_samples_kib": elide(samples),
        "rss_postwarmup_drift_kib": round(rss_drift),
        **port_keys(server, mem, loop_lag),
    }
    # Liveness: every client, the churn client too, survives; balanced
    # delivery; churn-driven layout replans (join + leave) observed; no
    # RSS slope. Cadence: the steady window within 1% of the 60 Hz ceiling
    # and p99 under the reference's 16.67 ms deadline (render.c:4-7).
    ok_liveness = (not failures and tick_error is None and total > 0
                   and balance > 0.5 and churn_events >= 3
                   and server.layout_replans >= 2 * churn_events
                   and (resize_events >= 3 or dt < 120)
                   and server.ticks / dt > 3 and rss_drift < 50_000)
    ok_cadence = (steady_ticks / steady_dt >= 59.4 and lat["p99_ms"] < 16.67)
    result["ok_liveness"] = ok_liveness
    result["ok_cadence"] = ok_cadence
    ok = ok_liveness and ok_cadence
    result["ok"] = ok
    if failures:
        result["died"] = failures
    if tick_error:
        result["server_tick_error"] = tick_error
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED (liveness={ok_liveness}, cadence={ok_cadence} "
          f"[steady {steady_ticks / steady_dt:.2f}/s p99={lat['p99_ms']}ms], "
          f"died={failures}, tick_error={tick_error}, "
          f"balance={balance:.2f}, churn={churn_events}, "
          f"replans={server.layout_replans}, drift={rss_drift:+.0f} KiB)")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
