#!/usr/bin/env python
"""Mixed-transport soak of the PyTorch port's server: TCP, WebSocket and
WebRTC clients against one live server tick for N seconds, watching
delivery, RSS and, on the card, device memory.

The counterpart of tools/soak_mixed.py, on ``asciichat_tpu_torch``: 2
production clients of the port over each transport (TCP, WebSocket with the
browser page's listener, a WebRTC DataChannel signalled through ``POST
/webrtc/offer`` on that listener), each uplinking the test pattern at 60x18
half-block truecolor. Where the twin prints its numbers as text, this one
prints them as one JSON line (docs/artifacts/soak_mixed_torch_r*.json),
with the steady window's stage split and the port's keys
(tools/torch_soak_common.port_keys). The clients ask for uncompressed
frames where the machine has no ``zstandard`` (``downlink_zstd`` in the
line). WebRTC needs ``cryptography`` and the system libssl. It serves on the
card unless ``ASCIICHAT_TORCH_DEVICE=cpu``.

Usage: python tools/torch_soak_mixed.py [seconds] (defaults 300)
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

CLIENTS = (("tcp-1", {}), ("tcp-2", {}),
           ("ws-1", {"use_ws": True}), ("ws-2", {"use_ws": True}),
           ("rtc-1", {"use_webrtc": True}), ("rtc-2", {"use_webrtc": True}))


async def main(seconds: float) -> int:
    from asciichat_tpu_torch.apps.webclient import WebRtcGateway, make_http_handler
    from asciichat_tpu_torch.net.websocket import serve_ws
    from asciichat_tpu_torch.render.types import ColorLevel, RenderMode

    server, tcp_srv, tcp_port, tick = await boot_server()
    gw = WebRtcGateway(server._handle_conn)

    def post(path, body):
        if path.split("?", 1)[0] == "/webrtc/offer":
            return gw.on_offer(body)
        return None

    ws_srv = await serve_ws(server._handle_conn, "127.0.0.1", 0,
                            pages=make_http_handler(), post=post)
    ws_port = ws_srv.sockets[0].getsockname()[1]

    counts: dict[str, int] = {}
    failures: dict[str, str] = {}
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + min(30.0, seconds / 4)
    devnull = open(os.devnull, "wb")

    async def run_client(name, kw):
        port = ws_port if kw else tcp_port
        c = make_client(port, devnull, w=60, h=18, color=ColorLevel.TRUECOLOR,
                        mode=RenderMode.HALF_BLOCK, **kw)
        got, err = await drive_client(c, deadline)
        counts[name] = got
        if err:
            failures[name] = err

    mem = MemorySampler(server.device, max(5.0, seconds / 20))
    loop_lag: dict = {}
    t0 = time.monotonic()
    await asyncio.gather(
        *(run_client(name, kw) for name, kw in CLIENTS),
        mem.run(deadline),
        lag_sampler(deadline, warmup_until, loop_lag),
        warmup_reset(server, warmup_until),
    )
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)
    gw.close()
    ws_srv.close()
    total = sum(counts.values())
    died = dict(failures)
    if tick_error:
        died["server_tick"] = tick_error
    rss_drift = drift(mem.rss)
    lat = server.tick_latency.stats_ms()
    result = {
        "soak": f"mixed_transport_{server.device.type}",
        "seconds": round(dt, 1),
        "clients": len(CLIENTS),
        "frames_delivered": total,
        "frames_per_s": round(total / dt, 1),
        "per_client": counts,
        "tick_rate": round(server.ticks / dt, 1),
        "ticks": server.ticks,
        "device_tick_computes": server.tick_compute_count,
        "latency_p50_ms": lat["p50_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "deadline_ms": 16.67,
        "stage_avg_ms": stage_avg_ms(server),
        "rss_start_kib": mem.rss0,
        "rss_peak_kib": max(mem.rss, default=mem.rss0),
        "rss_samples_kib": elide(mem.rss),
        "rss_postwarmup_drift_kib": round(rss_drift),
        **port_keys(server, mem, loop_lag),
    }
    # the twin's gates: alive and delivering, a modest tick floor (13 actors
    # share the host), no RSS slope
    ok = (not died and total > 0 and server.ticks / dt > 5
          and rss_drift < 50_000)
    result["ok"] = ok
    if died:
        result["died"] = died
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED ({died or 'low tick rate / RSS drift'})")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
