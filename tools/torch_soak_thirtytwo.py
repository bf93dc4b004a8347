#!/usr/bin/env python
"""32-client scale run of the PyTorch port's server: MAX_CLIENTS exercised,
and the 33rd client refused.

The counterpart of tools/soak_thirtytwo.py, on ``asciichat_tpu_torch``:

- admits 32 PRODUCTION clients of the port across 6 geometry/colour groups
  (a custom palette among them) with 6 filters;
- once the server is full and rendering, attempts a 33rd client and
  asserts that the server refuses it (``apps/server.py`` ``_handle_conn``,
  SERVER_FULL) without giving up a slot;
- asserts that every admitted client receives frames, balanced.

On the card every tick renders all 6 groups in one K3 launch. It serves on
the card unless ``ASCIICHAT_TORCH_DEVICE=cpu``. One JSON line
(docs/artifacts/soak_thirtytwo_torch_r*.json) with the twin's keys plus the
steady window's stage split and the port's (tools/torch_soak_common
.port_keys): the card, device-memory samples and drift, the kernels'
launches, failed device ticks, the loop lag.

Usage: python tools/torch_soak_thirtytwo.py [seconds] (defaults 180)
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

CLIENTS = 32
FILTERS = ["none", "green", "cyan", "magenta", "orange", "red"]
CUSTOM_PALETTE = " .:#@"


def geos():
    """soak_thirtytwo.py's 6 geometry/colour groups: w, h, colour, mode,
    palette."""
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode

    return [
        (60, 18, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, ""),
        (44, 14, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, ""),
        (72, 22, ColorLevel.COLOR_256, RenderMode.HALF_BLOCK, ""),
        (52, 16, ColorLevel.COLOR_256, RenderMode.FOREGROUND, ""),
        (40, 12, ColorLevel.COLOR_16, RenderMode.FOREGROUND, ""),
        (60, 18, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, CUSTOM_PALETTE),
    ]


def specs():
    """The 32 clients: name, then a geometry of :func:`geos` and a filter."""
    g = geos()
    return [(f"c{i:02d}", *g[i % len(g)], FILTERS[i % len(FILTERS)])
            for i in range(CLIENTS)]


async def main(seconds: float) -> int:
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode

    server, tcp_srv, port, tick = await boot_server()
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + min(60.0, seconds * 0.4)
    devnull = open(os.devnull, "wb")
    counts: dict[str, int] = {}
    failures: dict[str, str] = {}

    async def run_client(name, spec):
        w, h, color, mode, palette, filt = spec
        c = make_client(port, devnull, w=w, h=h, color=color, mode=mode,
                        palette=palette, filt=filt)
        got, err = await drive_client(c, deadline)
        counts[name] = got
        if err:
            failures[name] = err
        return got

    refusal: dict = {"attempted": False, "refused": False, "error": None}

    async def thirty_third():
        # once the table is full and the render loop is live, the 33rd
        # connection must be turned away by the SERVER_FULL path
        while time.monotonic() < deadline:
            await asyncio.sleep(2)
            if len(server.clients) >= CLIENTS and server.ticks > 30:
                break
        else:
            return
        refusal["attempted"] = True
        refusal["clients_at_attempt"] = len(server.clients)
        extra = make_client(port, devnull, w=50, h=15,
                            color=ColorLevel.TRUECOLOR,
                            mode=RenderMode.FOREGROUND)
        got, err = await drive_client(
            extra, min(deadline, time.monotonic() + 20))
        refusal["frames"] = got
        refusal["error"] = err
        # refused = saw the server-full error (or the closed socket) and
        # never received a frame
        refusal["refused"] = got == 0 and err is not None
        refusal["still_32"] = len(server.clients) <= CLIENTS

    mem = MemorySampler(server.device, max(5.0, seconds / 30))
    loop_lag: dict = {}
    t0 = time.monotonic()
    results = await asyncio.gather(
        *(run_client(name, spec) for name, *spec in specs()),
        thirty_third(),
        mem.run(deadline),
        lag_sampler(deadline, warmup_until, loop_lag),
        warmup_reset(server, warmup_until),
    )
    ticks_w, t_w = results[-1]  # steady-state window start (warmup_reset)
    steady_dt = time.monotonic() - t_w
    steady_ticks = server.ticks - ticks_w
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)

    nums = list(counts.values())
    total = sum(nums)
    balance = (min(nums) / max(nums)) if nums and max(nums) > 0 else 0.0
    lat = server.tick_latency.stats_ms()
    samples = mem.rss
    result = {
        "soak": f"thirtytwo_clients_{server.device.type}",
        "seconds": round(dt, 1),
        "clients": CLIENTS,
        "frames_delivered": total,
        "per_client_min": min(nums) if nums else 0,
        "per_client_max": max(nums) if nums else 0,
        "balance_min_over_max": round(balance, 3),
        "tick_rate": round(server.ticks / dt, 1),
        "tick_rate_steady": round(steady_ticks / steady_dt, 2),
        "ticks": server.ticks,
        "ticks_steady": steady_ticks,
        "device_tick_computes": server.tick_compute_count,
        "group_rebuilds": server.group_creates,
        "latency_p50_ms": lat["p50_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "deadline_ms": 16.67,
        "thirty_third": refusal,
        "rss_start_kib": mem.rss0,
        "rss_peak_kib": max(samples, default=mem.rss0),
        "rss_samples_kib": elide(samples),
        "stage_avg_ms": stage_avg_ms(server),
        "rss_postwarmup_drift_kib": round(drift(samples)),
        **port_keys(server, mem, loop_lag),
    }
    ok = (not failures and tick_error is None
          and len(counts) == CLIENTS and min(nums) > 0
          and balance > 0.3  # 32 clients share one interpreter with the server
          and refusal["attempted"] and refusal["refused"]
          and refusal.get("still_32", False)
          and server.ticks / dt > 1)
    result["ok"] = ok
    if failures:
        result["died"] = failures
    if tick_error:
        result["server_tick_error"] = tick_error
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED (admitted={len(counts)}, min={min(nums) if nums else 0}, "
          f"balance={balance:.2f}, refusal={refusal}, died={failures}, "
          f"tick_error={tick_error})")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 180.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
