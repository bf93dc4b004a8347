"""Shared soak-harness scaffolding for tools/torch_soak_*.py, the soaks of
the PyTorch port's server (``asciichat_tpu_torch``).

The counterpart of tools/soak_common.py: the latency, nine-client,
thirty-two-client and mixed-transport soaks boot the same in-process server
and tick loop, drive the port's PRODUCTION clients against it, window out
the warmup, and tear down observing failures. It imports only the port.

Where the JAX harness pins JAX to the CPU and opens its compile cache, this
one serves on ``runtime/device.default_device()``: the card, unless
``ASCIICHAT_TORCH_DEVICE=cpu``. On the card the CUDA kernels are built
(``runtime/kernel_build.cuda_lib``) before the server is booted, so the
warmup window measures serving and not ``nvcc``.

Every soak's line adds to its twin's keys (:func:`port_keys`): the device,
the card's name and power limit, the host's CPU count, the clients' uplink
rate, whether frames go down compressed, the server's failed device ticks,
its audio tick latency, every kernel's launches in the process, the event
loop's lag, and on the card the caching allocator's memory
(``torch.cuda.memory_allocated``, ``memory_reserved``) sampled beside RSS,
with ``max_memory_allocated`` and the post-warmup drift.
"""

from __future__ import annotations

import asyncio
import importlib.util
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The machine may lack `zstandard`: a client then sets the cannot-decompress
# bit (capabilities_mask bit 0, as `client --no-compress` does), so the
# server sends its frames uncompressed instead of failing to pack them.
DOWNLINK_ZSTD = importlib.util.find_spec("zstandard") is not None


def rss_kib() -> int:
    page = os.sysconf("SC_PAGE_SIZE")
    return int(open("/proc/self/statm").read().split()[1]) * page // 1024


def drift(samples: list) -> float:
    """Mean of the last quarter of ``samples`` minus that of the quarter
    before it (0 with fewer than 4): the post-warmup leak slope."""
    q = max(1, len(samples) // 4)
    if len(samples) < 4:
        return 0.0
    return sum(samples[-q:]) / q - sum(samples[-2 * q: -q]) / q


def elide(samples: list) -> list:
    """The first and last three of ``samples`` (all of them up to six)."""
    return samples[:3] + ["..."] + samples[-3:] if len(samples) > 6 else samples


def card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


class MemorySampler:
    """RSS and, on a CUDA device, the caching allocator's memory, sampled
    together every ``every`` seconds until ``until``."""

    def __init__(self, device, every: float):
        import torch

        self.device = device
        self.every = every
        self.cuda = device.type == "cuda"
        self.rss0 = rss_kib()
        self.rss: list[int] = []
        self.allocated: list[int] = []
        self.reserved: list[int] = []
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(device)
            self.allocated0 = torch.cuda.memory_allocated(device)

    def sample(self) -> None:
        import torch

        self.rss.append(rss_kib())
        if self.cuda:
            self.allocated.append(torch.cuda.memory_allocated(self.device))
            self.reserved.append(torch.cuda.memory_reserved(self.device))

    async def run(self, until: float) -> None:
        while time.monotonic() < until:
            await asyncio.sleep(self.every)
            self.sample()

    def device_memory(self) -> dict | None:
        """The card's memory over the run (None off the card)."""
        import torch

        if not self.cuda:
            return None
        return {
            "allocated_start_bytes": self.allocated0,
            "allocated_samples_bytes": elide(self.allocated),
            "reserved_samples_bytes": elide(self.reserved),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(self.device),
            "allocated_postwarmup_drift_bytes": round(drift(self.allocated)),
            "reserved_postwarmup_drift_bytes": round(drift(self.reserved)),
        }


def port_keys(server, mem: MemorySampler, loop_lag: dict) -> dict:
    """What every port soak's line adds to its twin's keys."""
    from asciichat_tpu_torch.models.server import RENDER_GROUP_KERNEL
    from asciichat_tpu_torch.ops import audio, cells, emit, resize

    kernels = (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL, RENDER_GROUP_KERNEL,
               audio.MIXER_KERNEL, audio.CAPTURE_KERNEL, emit.EMIT_KERNEL)
    return {
        "device": str(server.device),
        "card": card() if server.device.type == "cuda" else None,
        "cpu_count": os.cpu_count(),
        "uplink_fps": uplink_fps(),
        "downlink_zstd": DOWNLINK_ZSTD,
        "device_failures": server.device_failures,
        "audio_failures": server.audio_failures,
        # no soak client sends audio: the audio tick returns before it
        # mixes, and this stays empty unless one does
        "audio_tick_latency": server.audio_latency.stats_ms(),
        "kernel_launches": {k.name: k.launches for k in kernels},
        "loop_lag_ms": loop_lag,
        "device_memory": mem.device_memory(),
    }


def stage_avg_ms(server) -> dict:
    """The tick's per-stage averages since the last tracer reset."""
    return {k: round(t / max(n, 1) * 1e3, 3)
            for k, (t, n) in sorted(server.tick_tracer.snapshot().items())}


async def boot_server():
    """Build the kernels when the server's device is the card, then boot
    the in-process server and its tick loop. Returns (server, tcp_srv,
    port, tick_task)."""
    from asciichat_tpu_torch.apps.server import AsciiChatServer
    from asciichat_tpu_torch.net.transport import serve_tcp
    from asciichat_tpu_torch.runtime import kernel_build

    server = AsciiChatServer()
    if server.device.type == "cuda":
        kernel_build.cuda_lib()
    tcp_srv = await serve_tcp(server._handle_conn, "127.0.0.1", 0)
    port = tcp_srv.sockets[0].getsockname()[1]
    tick = asyncio.get_running_loop().create_task(server._tick_loop())
    return server, tcp_srv, port, tick


async def stop_server(tcp_srv, tick) -> str | None:
    """Cancel the tick loop and observe its outcome: a crash of the loop
    mid-soak is returned as its repr, for the line."""
    tick.cancel()
    err = None
    try:
        await tick
    except asyncio.CancelledError:
        pass
    except Exception as e:  # noqa: BLE001 — the whole point is to report it
        err = repr(e)
    tcp_srv.close()
    return err


def uplink_fps() -> float:
    """SOAK_UPLINK_FPS: the soak clients' capture rate (30 by default).
    Test-pattern generation, packing and CRC cost ~3.5 ms a 480p frame on
    the harness's one interpreter, so many clients at 30 fps can set the
    pace before the server renders anything; a lower rate leaves the
    interpreter to the server."""
    return float(os.environ.get("SOAK_UPLINK_FPS", "30"))


def make_client(port, devnull, *, w, h, color, mode, palette="", filt="none", **kw):
    """One PRODUCTION client of the port with a test-pattern source; its
    display thread writes to ``devnull``."""
    from asciichat_tpu_torch.apps.client import AsciiChatClient
    from asciichat_tpu_torch.net import protocol as proto
    from asciichat_tpu_torch.ops import filters
    from asciichat_tpu_torch.render.types import TerminalCapabilities
    from asciichat_tpu_torch.runtime.framesource import open_source
    from asciichat_tpu_torch.utils import term

    wc = proto.WireCapabilities(
        caps=TerminalCapabilities(color, mode), width=w, height=h,
        palette_custom=palette, palette_type=5 if palette else 0,
        color_filter=filters.FILTER_NAMES.index(filt),
    )
    if not DOWNLINK_ZSTD:
        wc.capabilities_mask |= 0x1
    c = AsciiChatClient("127.0.0.1", port, open_source(test_pattern=True), wc,
                        reconnect=False, capture_fps=uplink_fps(), **kw)
    # the display thread (models/session.DisplayThread) writes through the
    # sink's writer, so this swap reaches it
    c.display.writer = term.FrameWriter(devnull)
    return c


async def drive_client(client, until) -> tuple[int, str | None]:
    """Run a client until ``until`` -> (frames_received, error_repr|None).
    Cancelling ``run`` joins its display thread within
    ``apps/client.DISPLAY_JOIN_S``."""
    task = asyncio.create_task(client.run(max_frames=10**9))
    try:
        while time.monotonic() < until and not task.done():
            await asyncio.sleep(1.0)
        if task.done() and task.exception():
            return client.frames_received, repr(task.exception())
        return client.frames_received, None
    finally:
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass


async def warmup_reset(server, warmup_until) -> tuple[int, float]:
    """Once the warmup expires, apply the server's latency tuning and reset
    every tracker the line reports (the stage tracer too). Returns
    (ticks_at_steady, t_at_steady), the start of the steady window."""
    while time.monotonic() < warmup_until:
        await asyncio.sleep(0.5)
    server._tune_latency()
    server.tick_latency.reset()
    server.audio_latency.reset()
    server.frame_age.reset()
    server.tick_tracer.reset()
    return server.ticks, time.monotonic()


async def lag_sampler(until, warmup_until, out: dict) -> None:
    """The event loop's scheduling lag over the steady window: a 5 ms
    sleep's overshoot, the time any other task's step held the loop. Writes
    {"p50_ms", "p99_ms", "worst_ms", "samples"} into ``out``."""
    lags: list[float] = []
    while time.monotonic() < until:
        t0 = time.monotonic()
        await asyncio.sleep(0.005)
        lag = (time.monotonic() - t0 - 0.005) * 1e3
        if time.monotonic() >= warmup_until:
            lags.append(lag)
    lags.sort()
    if lags:
        out.update(
            p50_ms=round(lags[len(lags) // 2], 3),
            p99_ms=round(lags[int(len(lags) * 0.99)], 3),
            worst_ms=round(lags[-1], 3),
            samples=len(lags),
        )
