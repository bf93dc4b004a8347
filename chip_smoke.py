#!/usr/bin/env python3
"""Drive the PyTorch port's render path, audio mixer, live server and client,
its WebRTC and discovery modes, its sharded serving, the rest of its CLI,
its device ANSI emission, its ``bench`` mode and its server soaks once on
one NVIDIA card and check them.

    python3 chip_smoke.py [--k6-old PATH] [--k12-alt DIR]

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It imports no JAX. The phases run in order and any failure raises,
so the exit code is non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``asciichat_tpu_torch/csrc`` (nvcc);
3. K1 (resize) against its plain version, bit-exact, at the mirror's
   1080p -> 57x203 geometry, at odd shapes and at the timed shapes (1080p
   B=1, 8 and 128; 640x480, the webcam's, B=1 and 128; 3840x2160 B=32, whose
   column step is over a sector), each of them to the mirror's truecolor
   geometry; what the card's memory sustains for a 512 MiB copy and sum
   (``memory_rates``); K1 at every timed shape warm (calls replayed from a
   CUDA graph), eager and cold (each call after an L2 flush that writes 128
   MiB and reads 128 MiB, timed apart and left out), each against its
   32-byte-sector floor, and the library call warm and cold; with
   ``--k12-alt DIR`` (another design's ``resize.cu`` and ``cell_records.cu``
   with their headers and the package's entry points, e.g.
   ``tools/k12_staged``, or an earlier commit's ``csrc`` unpacked under
   ``build/``) that K1 too, built alone, held bit for bit against the
   package's and timed in turns package, alt, alt, package, warm, cold and
   eager;
4. ``render_cells`` (K2; K1 for the two half-block RGB modes) against the
   plain ``records_for_mode`` for all 10 modes, bit-exact, at 1080p B=8 (two
   heights), 640x480 B=8 and 3840x2160 B=32 (with ``--k12-alt``, the other
   K2 too); K2 (truecolor_fg) at phase 3's timed shapes as K1 is timed there;
5. K3 (server render, ``render_groups`` of one group) against the plain
   ``render_compute`` at the server's geometry: 9 sources of 800x600 ->
   203x64, per-receiver filters;
5b. three geometry groups (203x64 half-block truecolor with the server's
   filters, 160x48 256-colour with all 13 filters, 80x24 16-colour
   half-block) rendered by one K3 launch per tick for 20 ticks, bit-exact
   against the plain version and, for two ticks, byte-exact against the
   oracle, with one launch per tick; timed against three single-group
   calls, device only, eager and with the fetch;
5c. K3 at soak scale: the 32 receivers of ``tools/torch_soak_thirtytwo.py``
   in its 6 geometry groups (a custom palette among them; every receiver
   rendered, where the server renders each group's distinct filters once)
   over 32 sources of 800x600, one K3 launch a tick for 20 ticks: every
   record bit-exact against the plain version, and for two ticks one
   receiver a group byte-exact against the oracle; timed as phase 5b;
6. mirror: ``AsciiRenderer.convert_batch`` on 128 frames of 1080p, byte-exact
   against the oracle, and the mirror CLI's ``--snapshot`` in a subprocess;
6b. mirror ``--matrix``: the digital rain (``ops/rain.py``, torch code on the
   card, no kernel of its own) at 1080p against the plain CPU version, 24
   fields over 0-120 s: outside wrap pixels (where the CPU version's wobble
   lies within 1e-4 of an integer, at most 0.05% of the pixels) the field
   within 1e-4 and the overlaid frame within 1; the bytes rendered from the
   card's overlaid frame equal the oracle's; ``MirrorSession(matrix=True)``
   and the CLI's ``--matrix --snapshot`` on the card; the overlay timed per
   1080p frame;
6c. device ANSI emission (``ops/emit.py``): K6 (two launches, one CTA a
   tile of 1,024 cells of a frame) against its plain version (the whole
   worst-case buffer and the lengths, bit for bit) and every frame against
   ``oracle.render_truecolor_fg``, at 57x203 truecolor_fg records in
   batches of 1 (the mirror's), 9 (the server's) and 128 (the bench's):
   K2's of the bench's 1080p gradient, and random colours;
   ``emit_frames_device`` once, from a reset, for K6's launches; K6 timed
   eager, device only and plain at 128, and eager and device only at 1 and
   9; with ``--k6-old PATH`` (an earlier ``csrc/emit.cu``, e.g. the
   single-CTA kernel of commit dcf0071, unpacked under ``build/``) that
   kernel too, built alone, held bit for bit against K6 and timed in turns
   old, new, new, old; and the split of what K6 would replace: the records' fetch and the
   host emitter (one thread, then the emitter's default count) against K6
   and the fetch of its bytes and lengths (host clock, the same bytes
   either way);
7. server: ``RenderGroup.step`` and ``fetch`` for 100 ticks, every
   receiver's bytes against the oracle;
8. the launch counts of phase 6 (K1, K2) and phase 7 (K3), each path's
   own, from a reset just before it (each must be > 0);
9. K4 (the exclude-self mixer) against the plain ``mixer_process_reference``
   over 200 consecutive ticks at 9 sources x 480 samples with the state
   carried (bursts, dropped sources, one all-silent tick), then without
   exclude-self, at 1, 2 and 32 sources, and at 4096-sample ticks (which
   span several of the kernel's shared-memory windows at 32 sources);
10. ``ServerTick.step`` (K3 + K4) for 100 ticks: 9 sources of 800x600 ->
    203x64 half-block truecolor, 9 receivers, records against the plain
    tick and mixes within the tolerance; K3's and K4's launches in it > 0;
11. the live server: ``python -m asciichat_tpu_torch.apps.main server`` in a
    subprocess, 4 raw plaintext TCP clients: each gets frames byte-identical
    to the oracle, the exclude-self audio holds, and in a 5 s window where
    every client uploads pictures and audio the inspector shows the card, no
    failed device tick, and K3's and K4's launches in the server process
    (counted by their wrappers from the process's start), with the video
    and audio ticks' latency;
12. K5 (the client's capture chain: echo canceller, highpass, noise gate)
    against the plain ``capture_chain_reference`` over 300 carried frames
    at 256 taps x 480 samples (echo only, a flipped echo path that makes
    divergence control halve the weights, double talk, echo only again, a
    far-end underrun, silence that closes the gate), then at 1, 100 and 960
    samples, and without the AEC bit for bit; timed eager, device-only and
    plain;
13. the live client: the port's ``AsciiChatClient`` in this process, on the
    card, against a server subprocess as phase 11 starts it, sends an
    800x600 picture and a 440 Hz tone (500 frames): its frames are
    byte-identical to the oracle, a raw client hears the tone, and K5's
    launches equal the audio frames it sent, none failed; then
    ``python -m asciichat_tpu_torch.apps.main client`` with the picture on
    stdin and a tone exits 0 after 20 frames, the last byte-identical to the
    oracle;
14. the launch counts of every path so far (each must be > 0);
15. mirror ``--render-file`` (``models/renderfile.py``: records on the
    card, then the glyph raster or block colours and the YCbCr conversion
    in plain PyTorch on the card): 30 test-pattern frames at 203x64 in each
    of the 10 modes, with the standard and the ``blocks`` palette, rendered
    on the card and on the CPU (the plain version, which the CPU tests hold
    to the JAX package): the two ``.y4m`` files are equal byte for byte, and
    each frame launched K2 once, or K1 twice (top and bottom rows) in the two
    half-block RGB modes, and nothing else; one frame's time split (upload,
    device, fetch, host write) and ``render_to_file``'s frames/s in three
    modes; the CLI's ``mirror --test-pattern --render-file
    build/chip_smoke.y4m --max-frames 30`` in a subprocess; an ``.mp4``
    through ``NativeRecorder`` where the libavcodec shim loads and an encoder
    opens (a line says whether it ran and why);
16. web: ``apps.main server --ws-port P --mdns`` in a subprocess on the card,
    its mDNS socket an in-process bus (``MDNS_BUS``: nothing is sent onto
    the machine's network) and ``cryptography`` blocked in it, as on a
    machine without the package; the port's ``AsciiChatClient(use_ws=True)``
    in this process gets frames byte-identical to the oracle; a GET of every
    route of ``web.ASSETS`` returns the port's file bytes, and
    ``/servers.json`` (the server's own ``discover(timeout=2.0)``) lists the
    server's announcement; the server serves no WebRTC signaling: ``POST
    /webrtc/offer`` and ``/webrtc/candidate`` get 400, the JAX server's
    answer where its signaling is unavailable; the inspector shows the card
    and no failed tick;
17. WebRTC and discovery, where ``cryptography`` imports (else one line
    says why they did not run): the port's ``AsciiChatClient(use_webrtc=
    True)`` against ``apps.main server --ws-port`` in a subprocess (ICE,
    DTLS over the system libssl, SCTP; signaling on ``POST
    /webrtc/offer``), an 800x600 picture at 203x64 half-block truecolor:
    frames byte-identical to the oracle, K3's launches from the inspector;
    then ``apps.main discovery-service`` and a ``discovery`` host in
    subprocesses, a viewer in this process that joins the session through
    the service and gets the same oracle frames from the host's standby
    server, and ``apps.main discovery --join --max-frames 20`` where
    ``zstandard`` imports (its viewer asks for compressed frames); the
    host writes its K3 and K4 launches when it is stopped (K3 > 0). No
    STUN server is configured: nothing leaves the machine;
19. multi-device serving as forced meshes on the one card, and the rest of
    the CLI: ``render_groups`` of phase 5b's three geometry groups under
    meshes of 2, 4 and (4, 2) shards on ``cuda:0`` (``parallel/mesh.py``),
    10 ticks bit-identical to the unsharded K3 render, with one K3 launch a
    tick for each shard that holds a part, timed in turns against the
    unsharded tick (ticks/s through the fetch and the emitter, the render
    call's eager time and its device time replayed from a CUDA graph); ``apps.main server`` under
    ``ASCIICHAT_FORCE_MESH=4`` serves 4 raw clients frames equal to the
    oracle, and its inspector shows the mesh ``{"clients": 4}``,
    ``mesh_collectives`` 0 (every shard on one card), no failed tick, and in
    a steady window one K3 launch per tick for each shard with receivers
    (to within the one tick that may be in flight at each read),
    with its tick latency and ``convert`` stage; ``apps.main query PID`` of
    that server prints its Python stacks (the SIGUSR1 channel); ``mirror
    --config build/chip_smoke.toml --preset narrow --snapshot`` prints
    frames the preset's width wide (run beside the server);
20. ``python -m asciichat_tpu_torch.apps.main bench`` in a subprocess on the
    card (``apps/bench.py``; its stderr goes to
    ``build/chip_smoke_bench.err``): exit 0, one JSON line with every key,
    no ``smoke``, the byte gate passed, ``server_tick_rate`` > 0 and the
    kernel fingerprint of this library; the line is printed, and the report
    carries it as ``bench``;
21. the server soaks on the card: ``tools/torch_soak_nine.py`` (9 clients
    in 4 render groups, join/leave churn, live resizes; 100 s) and
    ``tools/torch_soak_thirtytwo.py`` (32 clients in 6 groups and a 33rd;
    80 s), uplink 5 frames/s, in subprocesses: every client served, the
    33rd refused, the device the card, no tick-loop error, no failed device
    tick and K3 launched; their steady ticks/s, tick p50/p99, RSS and
    device-memory drift are printed with the card (the cadence gates belong
    to the full-length runs), each one's stderr in
    ``build/chip_smoke_soak_{nine,thirtytwo}.err``;
18. the kernels, their launches on each path, their times against the
    plain versions and their bounds, as one JSON line, printed after phase
    21. A kernel's
    ``launches`` is the count on its user-facing path: the mirror (phase 6)
    for K1 and K2, the live server (phase 11) for K3 and K4, the live client
    (phase 13) for K5, ``emit_frames_device`` (phase 6c) for K6, which no
    serving path runs;
    ``launches_by_path`` holds every path's own count (``render_file``:
    phase 15's renders on the card; ``webrtc_server`` and
    ``discovery_host``: phase 17's, each a fresh process; ``server_mesh``:
    phase 19's server; ``soak_nine`` and ``soak_thirtytwo``: phase 21's,
    each a fresh process); the line also carries phase 6b's
    ``rain``, phase 15's ``render_file`` times, phase 16's ``web``, phase
    19's ``mesh``, phase 20's ``bench`` and phase 21's ``soaks``. ``ms`` is
    the eager time (CUDA events around back-to-back wrapper calls),
    ``device_ms`` the device-only time (calls replayed from one CUDA graph);
    K3's entry adds phase 5b's ``three_groups`` and phase 5c's
    ``soak_groups``, K6's phase 6c's ``split``. ``bound_ms`` is the larger of the bytes the function must move (each input byte read
    once, each output byte written once; for a gather, only the pixels it
    samples) over 3.35 TB/s and its operations over 67 TFLOP/s (the float32
    peak outside the tensor cores, taken for the integer ops too), both the
    H100 SXM's published peaks; ``bound_by`` says which; ``roofline_share``
    is ``bound_ms / device_ms``. For the gathers K1-K3,
    ``sector_floor_ms`` counts every distinct 32-byte sector that the
    sampled pixels touch in place of their bytes: the memory system moves
    whole sectors, so no gather of these pixels reads less. ``library_ms``
    is one PyTorch call that computes the same function (K1:
    ``frames[:, sy[:, None], sx]``; ``library_device_ms`` its device-only
    time), timed here and used nowhere in the port; no single PyTorch call
    computes K2, K3, K4, K5 or K6, so theirs is null. K6's entry adds
    ``small_batches`` (batches 1 and 9), ``design_bytes`` and
    ``design_bound_ms`` (what its two launches move: the function's bytes,
    the colours' second read and the tile sums written and read) and, with
    ``--k6-old``, ``old_single_cta``. K1's and K2's entries add
    ``cold_device_ms`` (phases 3 and 4's cold time at 1080p B=128),
    ``flush_ms`` (the flush left out of it), ``shapes`` (every timed shape:
    warm, eager and cold times, the sector floor and its shares, and with
    ``--k12-alt`` ``in_turns``), ``cold_sector_floor_share`` and
    ``cold_roofline_share``; their ``sector_floor_share`` is the warm one,
    as every kernel's is.
    K1's adds ``library_cold_device_ms`` and ``memory_rates``.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Records are compared exactly (tolerance 0: every record is uint8); the
mixer's float32 mixes within rtol=2e-4, atol=2e-5, the bound
tests/test_audio.py holds the JAX mixer to, and so are K5's output and
weights (its NLMS dot products sum in another order), its far tail,
hangover, gate state and frozen fraction exactly.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import dataclasses
import hashlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from asciichat_tpu_torch import web
from asciichat_tpu_torch.apps import bench as port_bench
from asciichat_tpu_torch.apps.client import AsciiChatClient
from asciichat_tpu_torch.models import renderfile, server
from asciichat_tpu_torch.models.mirror import MirrorSession
from asciichat_tpu_torch.models.session import DisplaySink
from asciichat_tpu_torch.net import packet as pkt
from asciichat_tpu_torch.net import protocol as proto
from asciichat_tpu_torch.net.transport import connect_tcp
from asciichat_tpu_torch.ops import audio, cells, compositor, emit, filters, pixel, rain, resize
from asciichat_tpu_torch.parallel import mesh as meshlib
from asciichat_tpu_torch.render import emitter, oracle, palette
from asciichat_tpu_torch.render.pipeline import AsciiRenderer, plan_render
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime import codecs, kernel_build
from asciichat_tpu_torch.runtime.audiodev import ToneSource
from asciichat_tpu_torch.runtime.device import require_cuda
from asciichat_tpu_torch.runtime.framesource import TestPatternSource

ROOT = Path(__file__).resolve().parent

SRC_H, SRC_W, BATCH = 1080, 1920, 128  # the mirror convert's cell (bench.py)
TERM_W, TERM_H = 203, 64
SERVER_SOURCES = 9  # MAX_COMPOSITE_SOURCES
UPLINK_W, UPLINK_H = 800, 600  # the server's uplink cap (apps/server.py:45)
SERVER_FILTERS = ["none", "green", "cyan", "none", "orange", "none", "pink",
                  "none", "rainbow"]
SERVER_TICKS = 100
ODD_RESIZES = [((48, 64), (12, 40)), ((37, 53), (20, 31)), ((16, 16), (40, 80)),
               ((240, 320), (57, 203))]

FG_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
HB_TRUECOLOR = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
FG_256 = TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND)
HB_16 = TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.HALF_BLOCK)
# phase 5b's geometry groups: (term_w, term_h, caps, receivers' filters)
THREE_GROUPS = [(TERM_W, TERM_H, HB_TRUECOLOR, SERVER_FILTERS),
                (160, 48, FG_256, filters.FILTER_NAMES),
                (80, 24, HB_16, ["white", "rainbow", "black"])]
GROUP_TICKS = 20
ORACLE_TICKS = 2
SOAK_SOURCES = 32  # phase 5c: the thirty-two soak's sources (MAX_CLIENTS)

MIXER_TICKS = 200
AUDIO_N = audio.AUDIO_FRAME_SAMPLES  # 480 samples: one 10 ms tick
AUDIO_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_audio.py:111
LIVE_FILTERS = ["none", "green", "none", "cyan"]
LIVE_WAIT_S = 120.0
LIVE_WINDOW_S = 5.0  # steady serving before the inspector is read
LIVE_UPLINK_FPS = 15  # each source's new pictures per second in that window
LIVE_AUDIO_HZ = 100  # each client's AUDIO_BATCHes (480 samples) per second

SRC_4K_H, SRC_4K_W, BATCH_4K = 2160, 3840, 32  # 56.7 bytes a column: over a sector
WEBCAM_H, WEBCAM_W = 480, 640  # the live mirror's webcam
FLUSH_BYTES = 128 << 20  # each of the L2 flush's two buffers

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SECTOR = 32  # bytes: the unit in which the card reads device memory

RAIN_TIMES = 24  # phase 6b's rain fields, over 0-120 s
RAIN_FIELD_TOL = 1e-4  # absolute, outside wrap pixels (tests/test_torch_rain.py)
RAIN_WRAP_DIST = 1e-4  # |wob - round(wob)| below this makes a wrap pixel
RAIN_WRAP_SHARE = 5e-4  # at most 0.05% of a window's pixels

CAPTURE_FRAMES = 300  # phase 12's carried frames at full width
CAPTURE_ARGS = dict(use_aec=True, taps=256, mu=0.5, geigel_t=0.5, hangover=1440,
                    gate_threshold=0.01)  # the one chain the client builds
CLIENT_AUDIO_FRAMES = 500  # the live client's tone: 5 s of 10 ms frames
CLI_FRAMES = 20
RF_FRAMES = 30  # phase 15's test-pattern frames per render
RF_PALETTES = ("standard", "blocks")  # blocks: UTF-8 glyphs, atlas row 95
RF_TIMED_MODES = ("truecolor_fg", "halfblock_truecolor", "256color")
MESH_SHAPES = ((2, 1), (4, 1), (4, 2))  # phase 19's meshes on the card: (clients, space)
MESH_TICKS = 10
MESH_FORCE = 4  # the live server's ASCIICHAT_FORCE_MESH
MESH_WINDOW_S = 2.0  # its steady window

EMIT_SPLIT_ROUNDS = 20  # phase 6c's host-clock rounds of the emission paths, in turns
EMIT_BATCHES = (1, 9, BATCH)  # phase 6c: the mirror's, the server's and the bench's batches
BENCH_LIMIT_S = 600  # phase 20's bench subprocess (about 20 s on one H100)
# phase 21's soaks: (tool, window in seconds, the clients' uplink frames/s);
# at 30 frames/s 32 in-process clients, not the server, set the tick's pace
SOAKS = (("nine", 100, 5), ("thirtytwo", 80, 5))
SOAK_SLACK_S = 240  # a soak's start (torch, the kernels' library) and teardown
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "eager_convert_fps",
              "emit_under_concurrency_fps", "end_to_end_onbox_fps",
              "end_to_end_pcie_projection_fps", "host_emit_fps", "host_emit_fps_mt",
              "host_emit_mt_threads", "pipeline_convert_fps", "pipeline_d2h_fps",
              "pipeline_d2h_mbps", "server_tick_rate", "kernel_fingerprint",
              "datachannel_fps", "versions"}

KERNELS = (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL,
           server.RENDER_GROUP_KERNEL, audio.MIXER_KERNEL, audio.CAPTURE_KERNEL,
           emit.EMIT_KERNEL)
# the path whose launches a kernel's `launches` reports (see phase 18)
MAIN_PATH = {"resize_nn": "mirror", "cell_records": "mirror",
             "render_group": "live_server", "mixer": "live_server",
             "capture_chain": "live_client", "device_emit": "device_emit"}

CARD = ""  # "name, power limit" of the card, set in phase 1
LIVE_STAGES: dict[str, dict] = {}  # live server -> its inspector's tick_stages_ms


def say(msg: str) -> None:
    print(msg, flush=True)


def make_frames(b: int, h: int, w: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """uint8 [b, h, w, 3] on ``device``: per-frame gradients plus noise
    from numpy (eight noise planes, reused cyclically)."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(
        rng.integers(0, 32, (min(b, 8), h, w, 3), dtype=np.uint8)).to(device)
    yy = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(b):
        r = (xx * 255 // max(w - 1, 1) + 7 * i).expand(h, w)
        g = (yy * 255 // max(h - 1, 1) + 13 * i).expand(h, w)
        bl = xx + yy + 29 * i
        base = torch.stack([r, g, bl], dim=-1)
        out[i] = ((base + noise[i % noise.shape[0]]) % 256).to(torch.uint8)
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn) -> torch.cuda.CUDAGraph:
    """A CUDA graph of one call of ``fn``, warmed up on a side stream and
    replayed once. ``fn`` must not copy from the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph: torch.cuda.CUDAGraph, reps: int) -> float:
    """Device milliseconds per replay of ``graph``, over ``reps`` replays."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``, replayed from one CUDA graph
    of ``iters`` calls: the time the card spends, without the host's
    launch cost. ``fn`` must not copy from the host. The calls follow each
    other, so what one call leaves in L2 the next may find: warm."""
    graph = capture(lambda: [fn() for _ in range(iters)])
    return replay_ms(graph, reps) / iters


class L2Flush:
    """What a caller that streams a large batch leaves in L2: nothing of the
    kernel's inputs. One call writes FLUSH_BYTES (over twice the H100's 50
    MB L2), then reads as many from a second buffer, so that L2 holds clean
    lines of neither the inputs nor dirty lines that the timed kernel would
    have to write back."""

    def __init__(self, dev: torch.device):
        self.written = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        self.read = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        self.sink = torch.empty((), dtype=torch.int64, device=dev)

    def __call__(self) -> None:
        self.written.fill_(7)
        torch.sum(self.read, dim=0, out=self.sink)


def cold_ms(fn, flush: L2Flush, iters: int = 10, reps: int = 5) -> tuple[float, float]:
    """(device milliseconds of one call of ``fn`` that finds L2 cold, of one
    flush): a graph of ``iters`` x (flush, fn) less a graph of ``iters``
    flushes, replayed in turns ``reps`` times, the median of the paired
    differences. The flush is timed apart and left out; what ``fn`` leaves
    dirty in L2 is written back during the next flush and counts as its own."""
    def flushes():
        for _ in range(iters):
            flush()

    def cold():
        for _ in range(iters):
            flush()
            fn()

    g_flush, g_cold = capture(flushes), capture(cold)
    pairs = []
    for _ in range(reps):
        f = replay_ms(g_flush, 1)
        pairs.append((replay_ms(g_cold, 1) - f, f))
    return (float(np.median([c for c, _ in pairs])) / iters,
            float(np.median([f for _, f in pairs])) / iters)


def memory_rates(dev, mib: int = 512) -> dict:
    """What the card's memory sustains for PyTorch's own streaming calls, as
    a yardstick for a kernel's share of HBM_BYTES_PER_S: a device-to-device
    copy (bytes read + written) and a sum (bytes read) of ``mib`` MiB,
    device time from CUDA graphs."""
    src = torch.empty(mib << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    words = src.view(torch.int64)
    sink = torch.empty((), dtype=torch.int64, device=dev)
    copy = graph_ms(lambda: dst.copy_(src), iters=5)
    read = graph_ms(lambda: torch.sum(words, dim=0, out=sink), iters=5)
    rates = {"copy_tb_s": 2 * src.numel() / copy / 1e9, "read_tb_s": src.numel() / read / 1e9}
    say(f"  memory: a {mib} MiB copy moves {rates['copy_tb_s']:.3f} TB/s (read + write), a sum "
        f"reads {rates['read_tb_s']:.3f} TB/s; the bounds use {HBM_BYTES_PER_S / 1e12:.2f} "
        f"[{CARD}]")
    return rates


def kernel_times(fn, flush: L2Flush) -> dict:
    """Warm device, eager and cold device milliseconds of one call."""
    cold, flush_ms = cold_ms(fn, flush)
    return {"device_ms": graph_ms(fn), "ms": cuda_ms(fn), "cold_device_ms": cold,
            "flush_ms": flush_ms}


def max_abs_err(got, want) -> int:
    """Largest |got - want| over a tensor or a record dict; raises on any
    difference of keys, shapes or dtypes."""
    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"record keys {list(got)} != {list(want)}")
        return max(max_abs_err(got[k], want[k]) for k in want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item())


def check_exact(label: str, got, want, errs: list[int]) -> None:
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    errs.append(err)
    if err != 0:
        raise AssertionError(f"{label}: max abs err {err}, expected 0")
    say(f"  ok  {label}: bit-exact")


def timing(label: str, kernel_ms: float, plain_ms: float, device_ms=None) -> None:
    graph = "" if device_ms is None else f" (device only, CUDA graph: {device_ms:.4f} ms)"
    say(f"  time {label}: kernel {kernel_ms:.4f} ms{graph}, plain {plain_ms:.4f} ms "
        f"[{CARD}]")


def nbytes(*tensors) -> int:
    """Bytes of tensors or record dicts, each counted once."""
    total = 0
    for t in tensors:
        total += nbytes(*t.values()) if isinstance(t, dict) else t.numel() * t.element_size()
    return total


def sampled_bytes(offsets: torch.Tensor) -> tuple[int, int]:
    """(distinct bytes, distinct 32-byte sectors x 32) of a gather that reads
    the 3 bytes at each of ``offsets`` (byte offsets of pixels)."""
    each = (offsets.reshape(-1, 1) + torch.arange(3, device=offsets.device)).reshape(-1)
    return (int(torch.unique(each).numel()),
            SECTOR * int(torch.unique(each // SECTOR).numel()))


def frame_offsets(b: int, h: int, w: int, tables: resize.IndexTables) -> torch.Tensor:
    """Byte offsets of the pixels a resize of a uint8 [b, h, w, 3] batch samples."""
    sy, sx = tables.sy.long(), tables.sx.long()
    rows = torch.arange(b, device=sy.device)[:, None] * h + sy[None, :]
    return ((rows[:, :, None] * w + sx[None, None, :]) * 3).reshape(-1)


def work(bytes_in: int, bytes_out: int, ops: float = 0.0, sector_bytes: int = 0,
         tables: int = 0) -> dict:
    """What a kernel's function must move and compute: bytes read (sampled
    pixels and tables) and written, its operations, and, for a gather, the
    bytes of the distinct sectors that its sampled pixels touch."""
    out = {"bytes": bytes_in + tables + bytes_out, "ops": ops}
    if sector_bytes:
        out["sector_bytes"] = sector_bytes + tables + bytes_out
    return out


def phase1_device() -> torch.device:
    global CARD
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    for line in lines:
        say(line)
    CARD = lines[0].strip()
    say(f"phase 1: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return dev


def phase2_build() -> None:
    t0 = time.monotonic()
    path, log = kernel_build.build_cuda(verbose=True)
    kernel_build.cuda_lib()
    say(f"phase 2: built {path.relative_to(ROOT)} in "
        f"{time.monotonic() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas {line.strip()}")


class AltK12:
    """K1 and K2 as another design has them (``path``: a directory with its
    resize.cu, cell_records.cu and their headers, whose entry points are the
    package's; the package's csrc is on the include path after it), built
    alone with the port's nvcc flags into build/, for timing in turns; the
    package never loads them."""

    def __init__(self, path: Path):
        files = (sorted(path.glob("*.cu")) + sorted(path.glob("*.cuh"))
                 + sorted(kernel_build.CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(b"".join(f.name.encode() + f.read_bytes()
                                         for f in files)).hexdigest()[:16]
        out = kernel_build.BUILD_DIR / f"libk12-alt-{digest}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            r = subprocess.run([kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, f"-I{path}",
                                f"-I{kernel_build.CSRC_DIR}", "-o", str(out), str(path / "resize.cu"),
                                str(path / "cell_records.cu")], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"build of {path} failed:\n{r.stderr[-4000:]}")
        self.path = path
        lib = ctypes.CDLL(str(out))
        self.k1, self.k2 = lib.ac_resize_nn, lib.ac_cell_records
        for fn in (self.k1, self.k2):
            fn.argtypes = kernel_build.ENTRY_POINTS[fn.__name__]
            fn.restype = ctypes.c_int

    def resize(self, frames: torch.Tensor, tables: resize.IndexTables) -> torch.Tensor:
        b, h, w, _ = frames.shape
        dh, dw = tables.sy.shape[0], tables.sx.shape[0]
        out = torch.empty((b, dh, dw, 3), dtype=torch.uint8, device=frames.device)
        self._check(self.k1(frames.data_ptr(), b, h, w, tables.sy.data_ptr(), dh,
                            tables.sx.data_ptr(), dw, out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream))
        return out

    def records(self, frames: torch.Tensor, tables: resize.IndexTables, ramp: torch.Tensor,
                mode: str) -> dict:
        b, h, w, _ = frames.shape
        family = cells.mode_family(mode)
        dh, dw = tables.sy.shape[0], tables.sx.shape[0]
        records = cells.allocate_records(family, b, dh, dw, frames.device)
        self._check(self.k2(family, frames.data_ptr(), b, h, w, tables.sy.data_ptr(), dh,
                            tables.sx.data_ptr(), dw, ramp.data_ptr(),
                            *cells.record_pointers(records),
                            torch.cuda.current_stream().cuda_stream))
        return records

    def _check(self, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"{self.path}: CUDA error {rc} at launch")


def timed_shapes(frames: torch.Tensor, webcam: torch.Tensor,
                 frames_4k: torch.Tensor) -> dict[str, tuple[torch.Tensor, int, int]]:
    """Phases 3 and 4's timed shapes: label -> (frames, dst_h px, dst_w), at
    the mirror's truecolor geometry for each source."""
    def geometry(f):
        plan = plan_render(f.shape[2], f.shape[1], TERM_W, TERM_H, FG_TRUECOLOR)
        return plan.dst_h_px, plan.dst_w
    return {"1080p_b1": (frames[:1], *geometry(frames)),
            "1080p_b8": (frames[:8], *geometry(frames)),
            f"1080p_b{BATCH}": (frames, *geometry(frames)),
            "480p_b1": (webcam[:1], *geometry(webcam)),
            f"480p_b{BATCH}": (webcam, *geometry(webcam)),
            f"4k_b{BATCH_4K}": (frames_4k, *geometry(frames_4k))}


def k12_calls(kind: str, f: torch.Tensor, dh: int, dw: int, ramp: torch.Tensor,
              alt: AltK12 | None) -> tuple:
    """(the package's call, the other design's call or None, its gather
    tables, its output bytes) of K1 or K2 (truecolor_fg) at one shape."""
    b, h, w, _ = f.shape
    if kind == "K1":
        tables = resize.resize_tables(h, w, dh, dw, f.device)
        return (lambda: resize.resize_nn(f, dh, dw, tables),
                None if alt is None else (lambda: alt.resize(f, tables)),
                tables, b * dh * dw * 3)
    ct = cells.cell_tables(h, w, dh, dw, f.device)
    return (lambda: cells.render_cells(f, ramp, dst_h=dh, dst_w=dw, mode="truecolor_fg",
                                       tables=ct),
            None if alt is None else (lambda: alt.records(f, ct.resize, ramp, "truecolor_fg")),
            ct.resize, b * dh * dw * 4)


def k12_shape_times(kind: str, shapes: dict, flush: L2Flush, ramp: torch.Tensor,
                    alt: AltK12 | None) -> dict:
    """K1's or K2's warm, eager and cold times at every timed shape, each
    against its sector floor; with ``alt``, the other design's kernel held
    bit for bit against the package's and both timed in turns package, alt,
    alt, package."""
    out = {}
    for label, (f, dh, dw) in shapes.items():
        pkg, alt_call, tables, out_bytes = k12_calls(kind, f, dh, dw, ramp, alt)
        b, h, w, _ = f.shape
        _, sectors = sampled_bytes(frame_offsets(b, h, w, tables))
        floor_bytes = sectors + out_bytes + nbytes(tables.sy, tables.sx)
        floor = floor_bytes / HBM_BYTES_PER_S * 1e3
        t = kernel_times(pkg, flush)
        entry = {"frames": b, "src": [h, w], "dst": [dh, dw],
                 "sector_bytes": floor_bytes,
                 "sector_floor_ms": floor, **t,
                 "cold_sector_floor_share": floor / t["cold_device_ms"],
                 "sector_floor_share": floor / t["device_ms"]}
        say(f"  time {kind} {label} -> {dh}x{dw}: device warm {t['device_ms']:.5f} ms, cold "
            f"{t['cold_device_ms']:.5f} ms (flush {t['flush_ms']:.5f} ms left out), eager "
            f"{t['ms']:.5f} ms; sector floor {floor:.5f} ms ({floor_bytes} B): "
            f"{entry['cold_sector_floor_share']:.1%} cold, "
            f"{entry['sector_floor_share']:.1%} warm [{CARD}]")
        if alt_call is not None:
            check_exact(f"{kind} {label}: the other design equals the package's", alt_call(),
                        pkg(), [])
            turns = {"package": [], "alt": []}
            for name in ("package", "alt", "alt", "package"):
                turns[name].append(kernel_times(alt_call if name == "alt" else pkg, flush))
            entry["in_turns"] = turns
            for key, what in (("device_ms", "warm"), ("cold_device_ms", "cold"), ("ms", "eager")):
                say(f"  time {kind} {label} in turns package, alt, alt, package, {what}: "
                    f"package {fmt([x[key] for x in turns['package']])} ms, alt "
                    f"{fmt([x[key] for x in turns['alt']])} ms [{CARD}]")
        out[label] = entry
    return out


def phase3_resize(dev, frames: torch.Tensor, errs: list[int], shapes: dict,
                  flush: L2Flush, alt: AltK12 | None) -> dict:
    say("phase 3: K1 resize vs plain")
    plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, FG_TRUECOLOR)
    dh, dw = plan.dst_h_px, plan.dst_w
    for b in (8, BATCH):
        check_exact(f"K1 1080p B={b} -> {dh}x{dw}",
                    resize.resize_nn(frames[:b], dh, dw),
                    pixel.resize_nn(frames[:b], dh, dw), errs)
    for i, (src, dst) in enumerate(ODD_RESIZES):
        f = make_frames(3, *src, seed=10 + i, device=dev)
        check_exact(f"K1 {src} -> {dst}", resize.resize_nn(f, *dst),
                    pixel.resize_nn(f, *dst), errs)
    for label, (f, sh, sw) in shapes.items():
        check_exact(f"K1 {label} -> {sh}x{sw}", resize.resize_nn(f, sh, sw),
                    pixel.resize_nn(f, sh, sw), errs)
    tables = resize.resize_tables(SRC_H, SRC_W, dh, dw, dev)
    sy, sx = tables.sy.long(), tables.sx.long()

    def library():  # one advanced-indexing call; the port never makes it
        return frames[:, sy[:, None], sx]

    check_exact(f"library frames[:, sy[:, None], sx] B={BATCH}", library(),
                resize.resize_nn(frames, dh, dw, tables), [])
    rates = memory_rates(dev)
    k = cuda_ms(lambda: resize.resize_nn(frames, dh, dw, tables))
    p = cuda_ms(lambda: pixel.resize_nn(frames, dh, dw))
    g = graph_ms(lambda: resize.resize_nn(frames, dh, dw, tables))
    lib, lib_g = cuda_ms(library), graph_ms(library)
    lib_cold, _ = cold_ms(library, flush)
    timing(f"K1 1080p B={BATCH} -> {dh}x{dw}", k, p, g)
    say(f"  time library frames[:, sy[:, None], sx]: {lib:.4f} ms (device only, CUDA graph: "
        f"{lib_g:.4f} ms warm, {lib_cold:.4f} ms cold) [{CARD}]")
    by_shape = k12_shape_times("K1", shapes, flush, torch.empty(0), alt)
    main = by_shape[f"1080p_b{BATCH}"]
    out = BATCH * dh * dw * 3
    sampled, sectors = sampled_bytes(frame_offsets(BATCH, SRC_H, SRC_W, tables))
    return dict(ms=k, plain_ms=p, device_ms=g, cold_device_ms=main["cold_device_ms"],
                flush_ms=main["flush_ms"], library_ms=lib, library_device_ms=lib_g,
                library_cold_device_ms=lib_cold, shapes=by_shape, memory_rates=rates,
                **work(sampled, out, 0.0, sectors, nbytes(tables.sy, tables.sx)))


def plain_cells(frames, ramp, dh, dw, mode):
    return cells.records_for_mode(pixel.resize_nn(frames, dh, dw), mode, ramp)


def phase4_cells(frames: torch.Tensor, errs: list[int], shapes: dict, flush: L2Flush,
                 alt: AltK12 | None) -> dict:
    say("phase 4: render_cells (K2, K1 for half-block RGB) vs plain, 10 modes")
    ramp = cells.ramp_for_palette(palette.DEFAULT_PALETTE)
    f8 = frames[:8]
    checked = {"1080p_b8": f8, "480p_b8": shapes[f"480p_b{BATCH}"][0][:8],
               f"4k_b{BATCH_4K}": shapes[f"4k_b{BATCH_4K}"][0]}
    for mode in cells.MODES:
        half = cells.mode_family(mode) in cells.HALFBLOCK_FAMILIES
        for label, f in checked.items():
            if label == "1080p_b8":
                dw, heights = TERM_W, ((2 * TERM_H, 57) if half else (TERM_H, 57))
            else:
                plan = plan_render(f.shape[2], f.shape[1], TERM_W, TERM_H, caps_for_mode(mode))
                dw, heights = plan.dst_w, (plan.dst_h_px,)
            for dh in heights:
                got = cells.render_cells(f, ramp, dst_h=dh, dst_w=dw, mode=mode)
                check_exact(f"{mode} {label} -> {dh}px x {dw}", got,
                            plain_cells(f, ramp, dh, dw, mode), errs)
                if alt is not None and not half:
                    t = cells.cell_tables(f.shape[1], f.shape[2], dh, dw, f.device)
                    check_exact(f"{mode} {label}: the other design's K2 equals the package's",
                                alt.records(f, t.resize, ramp, mode), got, [])
        dh = 2 * TERM_H if half else TERM_H
        tables = cells.cell_tables(SRC_H, SRC_W, dh, TERM_W, frames.device)
        k = cuda_ms(lambda: cells.render_cells(f8, ramp, dst_h=dh, dst_w=TERM_W,
                                               mode=mode, tables=tables))
        p = cuda_ms(lambda: plain_cells(f8, ramp, dh, TERM_W, mode))
        timing(f"{mode} 1080p B=8 -> {dh}px x {TERM_W}", k, p)
    plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, FG_TRUECOLOR)
    tables = cells.cell_tables(SRC_H, SRC_W, plan.dst_h_px, plan.dst_w, frames.device)
    args = dict(dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode)
    check_exact(f"{plan.mode} 1080p B={BATCH} (mirror geometry)",
                cells.render_cells(frames, ramp, tables=tables, **args),
                plain_cells(frames, ramp, plan.dst_h_px, plan.dst_w, plan.mode), errs)
    k = cuda_ms(lambda: cells.render_cells(frames, ramp, tables=tables, **args))
    p = cuda_ms(lambda: plain_cells(frames, ramp, plan.dst_h_px, plan.dst_w, plan.mode))
    g = graph_ms(lambda: cells.render_cells(frames, ramp, tables=tables, **args))
    timing(f"K2 {plan.mode} 1080p B={BATCH} -> {plan.dst_h_px}x{plan.dst_w}", k, p, g)
    by_shape = k12_shape_times("K2", shapes, flush, ramp, alt)
    main = by_shape[f"1080p_b{BATCH}"]
    records = cells.render_cells(frames, ramp, tables=tables, **args)
    sampled, sectors = sampled_bytes(frame_offsets(BATCH, SRC_H, SRC_W, tables.resize))
    cell_count = BATCH * plan.dst_h_px * plan.dst_w
    # ops: luma (3 multiplies, 3 adds, a shift) per cell
    return dict(ms=k, plain_ms=p, device_ms=g, cold_device_ms=main["cold_device_ms"],
                flush_ms=main["flush_ms"], library_ms=None, shapes=by_shape,
                **work(sampled, nbytes(records), 7.0 * cell_count, sectors,
                       nbytes(tables.resize.sy, tables.resize.sx)))


def device_params(grp: server.RenderGroup, dev) -> list[torch.Tensor]:
    """The group's host filter vectors, on the card."""
    return [t.to(dev) for t in (grp.tint, grp.fg_on_bg, grp.is_rainbow, grp.filter_on)]


def plain_group(grp: server.RenderGroup, stack: torch.Tensor, params=None) -> dict:
    """The plain render of ``grp`` on the card, with its filter vectors as
    they stand (or ``params``, those vectors already on the card)."""
    m, r = grp.maps, grp.render
    if params is None:
        params = device_params(grp, stack.device)
    return server.render_compute(stack, grp.ramp, *params, m.cidx, m.src_y, m.src_x,
                                 m.comp_mask, mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)


def phase5_group(dev, stack: torch.Tensor, errs: list[int]) -> dict:
    say("phase 5: K3 render_groups vs plain render_compute")
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    result = None
    for caps in (HB_TRUECOLOR, FG_256):
        grp = server.RenderGroup(sizes, TERM_W, TERM_H, caps, SERVER_FILTERS,
                                 device=dev)
        arena = server.RecordArena(dev)
        r = grp.render

        def kernel():
            return server.render_groups(stack, [grp], 1.25, arena)[0]

        label = (f"K3 {r.mode} {SERVER_SOURCES}x{UPLINK_W}x{UPLINK_H} -> "
                 f"{r.dst_h_px}px x {r.dst_w}, {len(SERVER_FILTERS)} receivers")
        records = kernel()  # the rainbow tint at 1.25 s
        params = device_params(grp, dev)
        want = plain_group(grp, stack, params)
        check_exact(label, records, want, errs)
        # the array-level call, which makes its launch job and records afresh
        check_exact(f"{label}, render_group", server.render_group(
            stack, grp.ramp, grp.tint, grp.fg_on_bg, grp.is_rainbow, grp.filter_on, grp.maps,
            mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w), want, errs)
        k = cuda_ms(kernel)
        p = cuda_ms(lambda: plain_group(grp, stack, params))
        g = graph_ms(kernel)
        timing(label, k, p, g)
        if result is None:  # the live server's half-block truecolor group
            words = grp.maps.words(stack.shape)
            sampled, sectors = sampled_bytes(words[words >= 0].long())
            # ops: colour filter and luma, ~20 integer ops per pixel per receiver
            ops = 20.0 * nbytes(records) / 3
            result = dict(ms=k, plain_ms=p, device_ms=g, library_ms=None,
                          **work(sampled, nbytes(records), ops, sectors,
                                 4 * r.dst_h_px * r.dst_w))  # one map word per pixel
    return result


def group_bytes(g: server.RenderGroup, geometry: tuple, host: dict,
                composite: np.ndarray, time_s: float, receivers=None) -> None:
    """The emitted frames of ``host`` (g's fetched records) of every
    receiver, or of the indices in ``receivers``, against the oracle applied
    to the filtered composite; ``geometry`` is the group's (term_w, term_h,
    caps, filters)."""
    term_w, term_h, caps, names = geometry
    r = g.render
    outs = emitter.emit_frames(host, r.mode, g.palette, pad_w=r.pad_w, pad_h=r.pad_h)
    rows = 2 * term_h if caps.render_mode == RenderMode.HALF_BLOCK else term_h
    for c in range(len(names)) if receivers is None else receivers:
        want = oracle.ascii_convert_with_capabilities(
            filters.apply_color_filter_reference(composite, names[c], time_s), term_w, rows,
            caps, palette=g.palette)
        if outs[c] != want:
            raise AssertionError(f"{r.mode} receiver {c} ({names[c]}) differs from the oracle")


def group_ticks(stack: torch.Tensor, groups: list, geometries: list, errs: list[int],
                receivers=None) -> int:
    """GROUP_TICKS ticks of ``render_groups`` over ``groups``: every record
    bit-exact against the plain render, and for ORACLE_TICKS ticks the
    receivers' frames (all, or the indices in ``receivers``) against the
    oracle. Returns K3's launches, which must be one a tick."""
    sizes = [(UPLINK_W, UPLINK_H)] * stack.shape[0]
    host_stack = stack.cpu().numpy()
    composites = [compositor.composite_reference(host_stack,
                                                 compositor.plan_composite(sizes, w, h))
                  for w, h, _, _ in geometries]
    arena = server.RecordArena(stack.device)
    reset_launches()
    for t in range(GROUP_TICKS):
        time_s = 100.0 + t / 60
        records = server.render_groups(stack, groups, time_s, arena)
        torch.cuda.synchronize()
        for g, rec in zip(groups, records):
            err = max_abs_err(rec, plain_group(g, stack))
            errs.append(err)
            if err:
                raise AssertionError(f"tick {t} {g.render.mode}: max abs err {err}")
        if t < ORACLE_TICKS:
            for g, geometry, host, comp in zip(groups, geometries, arena.fetch(records),
                                               composites):
                group_bytes(g, geometry, host, comp, time_s, receivers)
    launches = read_launches()[server.RENDER_GROUP_KERNEL.name]
    if launches != GROUP_TICKS:
        raise AssertionError(f"{launches} K3 launches over {GROUP_TICKS} ticks, "
                             "expected one a tick")
    return launches


def time_groups(stack: torch.Tensor, groups: list) -> dict:
    """One ``render_groups`` launch a tick against a call per group, in
    turns: device only, eager and with the fetch (host clock)."""
    arena = server.RecordArena(stack.device)

    def one():
        return server.render_groups(stack, groups, 100.0, arena)

    def separate():
        return [g.step(stack, 100.0) for g in groups]

    def one_fetched():
        arena.fetch(one())

    def separate_fetched():
        for g in groups:
            g.fetch(g.step(stack, 100.0))

    out: dict[str, dict[str, list[float]]] = {"one": {}, "separate": {}}
    for name in ("one", "separate", "separate", "one"):  # in turns
        fn, fetched = (one, one_fetched) if name == "one" else (separate, separate_fetched)
        runs = out[name]
        runs.setdefault("device_ms", []).append(graph_ms(fn))
        runs.setdefault("ms", []).append(cuda_ms(fn, iters=50))
        runs.setdefault("fetched_ms", []).append(host_ms(fetched))
    for name, runs in out.items():
        say(f"  time {name} ({'one launch' if name == 'one' else 'a call per group'}): "
            f"device only {fmt(runs['device_ms'])} ms, eager {fmt(runs['ms'])} ms, with "
            f"the fetch {fmt(runs['fetched_ms'])} ms (host clock) [{CARD}]")
    return out


def group_shapes(groups: list) -> str:
    return ", ".join(f"{g.render.mode} {g.render.dst_h_px}px x {g.render.dst_w} x "
                     f"{len(g.filter_names)}" for g in groups)


def phase5b_three_groups(dev, stack: torch.Tensor, errs: list[int]) -> dict:
    say(f"phase 5b: {len(THREE_GROUPS)} geometry groups in one K3 launch per tick, "
        f"{GROUP_TICKS} ticks")
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    groups = [server.RenderGroup(sizes, w, h, caps, names, device=dev)
              for w, h, caps, names in THREE_GROUPS]
    launches = group_ticks(stack, groups, THREE_GROUPS, errs)
    shapes = group_shapes(groups)
    say(f"  ok  {GROUP_TICKS} ticks of {shapes}: bit-exact, one K3 launch a tick; "
        f"{ORACLE_TICKS} ticks byte-identical to the oracle")
    return {"groups": shapes, "ticks": GROUP_TICKS, "launches": launches,
            **time_groups(stack, groups)}


def soak_groups() -> tuple[list[tuple], list[str]]:
    """tools/torch_soak_thirtytwo.py's clients as render groups: each
    geometry's (term_w, term_h, caps, every receiver's filter) and palette.
    Unlike the server, which renders a filter once for all of a group's
    receivers that share it, every receiver here is rendered."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_soak_thirtytwo as t32

    geometries, palettes = [], []
    for g, (w, h, color, mode, custom) in enumerate(t32.geos()):
        names = [spec[-1] for spec in t32.specs()[g::len(t32.geos())]]
        geometries.append((w, h, TerminalCapabilities(color, mode), names))
        palettes.append(custom or palette.DEFAULT_PALETTE)
    return geometries, palettes


def phase5c_soak_groups(dev, errs: list[int]) -> dict:
    geometries, palettes = soak_groups()
    receivers = sum(len(g[3]) for g in geometries)
    say(f"phase 5c: K3 at soak scale, {receivers} receivers in {len(geometries)} geometry "
        f"groups over {SOAK_SOURCES} sources of {UPLINK_W}x{UPLINK_H}, one launch a tick, "
        f"{GROUP_TICKS} ticks")
    stack = make_frames(SOAK_SOURCES, UPLINK_H, UPLINK_W, seed=7, device=dev)
    sizes = [(UPLINK_W, UPLINK_H)] * SOAK_SOURCES
    groups = [server.RenderGroup(sizes, w, h, caps, names, pal_, device=dev)
              for (w, h, caps, names), pal_ in zip(geometries, palettes)]
    launches = group_ticks(stack, groups, geometries, errs, receivers=[0])
    shapes = group_shapes(groups)
    say(f"  ok  {GROUP_TICKS} ticks of {shapes}: bit-exact, one K3 launch a tick; "
        f"{ORACLE_TICKS} ticks of one receiver a group byte-identical to the oracle")
    return {"groups": shapes, "receivers": receivers, "sources": SOAK_SOURCES,
            "ticks": GROUP_TICKS, "launches": launches, **time_groups(stack, groups)}


def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the host's clock; ``fn``
    ends by waiting for the card."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def fmt(values: list[float]) -> str:
    return ", ".join(f"{v:.5f}" for v in values)


def test_pattern_frames(elapsed: float) -> list[np.ndarray]:
    """Every frame the mirror's test-pattern source (640x480) can show in
    its first ``elapsed`` seconds: it moves a colour phase 60 steps/s and a
    bar 160 px/s, so one frame per interval between those steps."""
    src = TestPatternSource()
    steps = sorted({k / 160 for k in range(int(elapsed * 160) + 2)}
                   | {k / 60 for k in range(int(elapsed * 60) + 2)})
    frames = []
    for a, b in zip(steps, steps[1:]):
        if b - a < 1e-4:
            continue
        src._t0 = time.monotonic() - (a + b) / 2  # read() at time (a+b)/2
        frames.append(src.read())
    return frames


def mirror_cli_check(renderer: AsciiRenderer) -> None:
    """Run the mirror CLI's snapshot in a subprocess and hold its frame
    against the oracle. The test pattern depends on when the source was
    opened, so the frame is found among the pattern's possible frames
    (rendered by the port on the card) and that frame's oracle bytes must
    equal the CLI's output."""
    env = dict(os.environ, COLORTERM="truecolor", LANG="C.UTF-8")
    env.pop("NO_COLOR", None)
    cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "mirror",
           "--test-pattern", "--snapshot", "--width", "80", "--height", "24"]
    t0 = time.monotonic()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, timeout=300)
    elapsed = time.monotonic() - t0
    if r.returncode != 0 or not r.stdout.endswith(b"\n"):
        raise RuntimeError(f"mirror CLI exited {r.returncode}:\n"
                           f"{r.stderr.decode(errors='replace')[-3000:]}")
    frame = r.stdout[:-1]  # a non-tty writer ends each frame with a newline
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND,
                                wants_padding=False, utf8_support=True)
    candidates = test_pattern_frames(elapsed)
    for start in range(0, len(candidates), 256):
        chunk = candidates[start:start + 256]
        outs = renderer.convert_batch(np.stack(chunk), 80, 24, caps)
        if frame in outs:
            src = chunk[outs.index(frame)]
            want = oracle.ascii_convert_with_capabilities(src, 80, 24, caps)
            if want != frame:
                raise AssertionError("mirror CLI frame differs from the oracle")
            say(f"  ok  mirror CLI --snapshot 80x24 ({len(frame)} bytes, "
                f"{elapsed:.1f} s): byte-identical to the oracle")
            return
    raise AssertionError(f"mirror CLI frame matches none of the "
                         f"{len(candidates)} test-pattern frames")


def phase6_mirror(dev, frames: torch.Tensor) -> None:
    say(f"phase 6: mirror convert_batch, {BATCH} x 1080p -> {TERM_W}x{TERM_H}")
    renderer = AsciiRenderer(device=dev)
    host = frames[:2].cpu().numpy()
    for caps in (FG_TRUECOLOR, HB_TRUECOLOR):
        outs = renderer.convert_batch(frames, TERM_W, TERM_H, caps)
        if len(outs) != BATCH:
            raise AssertionError(f"{len(outs)} frames for a batch of {BATCH}")
        for i in range(2):
            want = oracle.ascii_convert_with_capabilities(host[i], TERM_W, TERM_H, caps)
            if outs[i] != want:
                raise AssertionError(f"{caps.renderer_key()} frame {i} differs "
                                     "from the oracle")
        say(f"  ok  {caps.renderer_key()}: frames 0-1 byte-identical to the oracle")
        plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, caps)
        dev_ms = cuda_ms(lambda: renderer.cells_for_plan(frames, plan), iters=10)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            renderer.convert_batch(frames, TERM_W, TERM_H, caps)
        wall = (time.perf_counter() - t0) / reps
        say(f"  rate {caps.renderer_key()}: device {BATCH / dev_ms * 1e3:.0f} "
            f"frames/s ({dev_ms:.4f} ms per batch), through D2H + emit "
            f"{BATCH / wall:.0f} frames/s [{CARD}]")
    mirror_cli_check(renderer)


def rain_wrap(cpu_field: torch.Tensor) -> torch.Tensor:
    """Wrap pixels of a plain field: its wobble within RAIN_WRAP_DIST of an
    integer (the field is 1 - fract(wobble))."""
    fract = 1.0 - cpu_field.double()
    return torch.minimum(fract, 1.0 - fract) < RAIN_WRAP_DIST


def phase6b_matrix(dev, frames: torch.Tensor) -> dict:
    say(f"phase 6b: mirror --matrix, the rain at {SRC_W}x{SRC_H} against the plain CPU version")
    card = rain.DigitalRain(SRC_W, SRC_H, device=dev)
    host = rain.DigitalRain(SRC_W, SRC_H)
    wraps = 0
    field_err = frame_err = 0.0
    overlaid = []
    for k, t in enumerate(np.linspace(0.0, 120.0, RAIN_TIMES)):
        want = host.brightness_field(float(t))
        got = card.brightness_field(float(t)).cpu()
        wrap = rain_wrap(want)
        wraps += int(wrap.sum())
        field_err = max(field_err, float((got - want).abs()[~wrap].max()))
        frame = frames[k % frames.shape[0]]
        out = card.apply(frame, float(t))
        ref = host.apply(frame.cpu(), float(t))
        frame_err = max(frame_err, float(
            (out.cpu().to(torch.int16) - ref.to(torch.int16)).abs()[~wrap].max()))
        if k < 2:
            overlaid.append(out)
    share = wraps / (RAIN_TIMES * SRC_W * SRC_H)
    if field_err > RAIN_FIELD_TOL or frame_err > 1 or share > RAIN_WRAP_SHARE:
        raise AssertionError(f"rain on the card: field err {field_err}, frame err {frame_err}, "
                             f"wrap share {share} (bound {RAIN_FIELD_TOL}, 1, {RAIN_WRAP_SHARE})")
    say(f"  ok  {RAIN_TIMES} fields: max field err {field_err:.3g} and max frame err "
        f"{frame_err:.0f} outside {wraps} wrap pixels ({share:.3%})")
    renderer = AsciiRenderer(device=dev)
    for out in overlaid:
        got = renderer.convert(out, TERM_W, TERM_H, FG_TRUECOLOR)
        want = oracle.ascii_convert_with_capabilities(out.cpu().numpy(), TERM_W, TERM_H,
                                                      FG_TRUECOLOR)
        if got != want:
            raise AssertionError("the bytes of an overlaid frame differ from the oracle's")
    session = MirrorSession(StillSource(frames[0].cpu().numpy()), FG_TRUECOLOR, TERM_W, TERM_H,
                            palette.DEFAULT_PALETTE, matrix=True, device=dev)
    session.display = DisplaySink(stream=io.BytesIO())
    seen = []
    convert = session.renderer.convert
    session.renderer.convert = lambda f, *a, **kw: seen.append(f) or convert(f, *a, **kw)
    snap = session.run_snapshot()
    if (not isinstance(seen[0], torch.Tensor) or seen[0].device != dev
            or snap != oracle.ascii_convert_with_capabilities(
                seen[0].cpu().numpy(), TERM_W, TERM_H, FG_TRUECOLOR)):
        raise AssertionError("MirrorSession(matrix=True): not the oracle's bytes of the "
                             "frame overlaid on the card")
    say("  ok  overlaid frames 0-1 and MirrorSession(matrix=True)'s snapshot (overlaid on "
        "the card): byte-identical to the oracle")
    env = dict(os.environ, COLORTERM="truecolor", LANG="C.UTF-8")
    env.pop("ASCIICHAT_TORCH_DEVICE", None)
    cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "mirror", "--test-pattern",
           "--matrix", "--snapshot", "--width", "80", "--height", "24", "--stretch"]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, timeout=300)
    lines = r.stdout.rstrip(b"\n").split(b"\n")
    if r.returncode != 0 or len(lines) != 24:
        raise RuntimeError(f"mirror --matrix CLI exited {r.returncode} with {len(lines)} lines:\n"
                           f"{r.stderr.decode(errors='replace')[-3000:]}")
    say("  ok  mirror CLI --test-pattern --matrix --snapshot 80x24 on the card: exit 0, 24 lines")
    frame = frames[0]
    ms = cuda_ms(lambda: card.apply(frame, 7.5), iters=50)
    field_ms = cuda_ms(lambda: card.brightness_field(7.5), iters=50)
    host_frame = frame.cpu()
    plain = host_ms(lambda: host.apply(host_frame, 7.5), iters=3, warmup=1)
    say(f"  time rain overlay per {SRC_W}x{SRC_H} frame on the card: {ms:.4f} ms (field alone "
        f"{field_ms:.4f} ms); plain CPU {plain:.3f} ms [{CARD}]")
    return {"overlay_ms": ms, "field_ms": field_ms, "plain_cpu_ms": plain,
            "max_field_err": field_err, "max_frame_err": frame_err, "wrap_share": share}


def emission_records(dev) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Phase 6c's records at the mirror's cell (128 x 57x203 truecolor_fg):
    K2's of the bench's 1080p gradient, and random colours with their luma."""
    plan = plan_render(SRC_W, SRC_H, TERM_W, TERM_H, FG_TRUECOLOR)
    frames = port_bench.make_frames(BATCH, SRC_H, SRC_W, dev)
    recs = cells.render_cells(frames, cells.ramp_for_palette(palette.DEFAULT_PALETTE),
                              dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode)
    del frames
    rng = np.random.default_rng(31)
    rgb = torch.from_numpy(rng.integers(0, 256, (BATCH, plan.dst_h_px, plan.dst_w, 3),
                                        dtype=np.uint8)).to(dev)
    return {"gradient": (recs["rgb"], recs["luma"]),
            "random": (rgb, pixel.luminance(rgb).to(torch.uint8))}


def in_turns(fns: dict, rounds: int) -> dict[str, float]:
    """Median host-clock milliseconds of each callable, run in turns: one
    call of each a round, after one warm-up round, so that a slow spell of
    the host falls on all of them alike."""
    for fn in fns.values():
        fn()
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(v)) for name, v in samples.items()}


def emission_split(rgb: torch.Tensor, luma: torch.Tensor, tbl: torch.Tensor) -> dict:
    """Host-clock milliseconds per batch (medians, in turns) of what K6
    would replace and of K6: the records' fetch and the host emitter (one
    thread, then the emitter's default count), against K6 and the fetch of
    its bytes and lengths, each path ending with its bytes on the host; the
    two give the same bytes."""
    b, h, w, _ = rgb.shape
    recs = {"rgb": rgb, "luma": luma}
    staging = cells.HostStaging()
    data_host = torch.empty((b, emit.worst_bytes(h, w)), dtype=torch.uint8, pin_memory=True)
    lens_host = torch.empty((b,), dtype=torch.int32, pin_memory=True)
    threads = emitter._DEFAULT_THREADS

    def fetch_records():
        return cells.records_to_numpy(recs, staging)

    def host_emit(host, nthreads):
        return emitter.emit_frames(host, "truecolor_fg", palette.DEFAULT_PALETTE,
                                   nthreads=nthreads, copy=False)

    def fetch_bytes(data, lengths):
        data_host.copy_(data, non_blocking=True)
        lens_host.copy_(lengths, non_blocking=True)
        torch.cuda.current_stream().synchronize()

    def device_path():
        fetch_bytes(*emit.emit_truecolor_fg(rgb, luma, tbl))

    host = fetch_records()
    outs = host_emit(host, threads)
    device_path()
    lens = lens_host.numpy()
    for i in range(b):
        if bytes(outs[i]) != data_host.numpy()[i, :lens[i]].tobytes():
            raise AssertionError(f"K6 frame {i} differs from the host emitter's")
    data, lengths = emit.emit_truecolor_fg(rgb, luma, tbl)
    split = {"frames": b, "threads": threads, **in_turns({
        "fetch_records_ms": fetch_records,
        "emit_1t_ms": lambda: host_emit(host, 1),
        "emit_mt_ms": lambda: host_emit(host, threads),
        "records_path_1t_ms": lambda: host_emit(fetch_records(), 1),
        "records_path_mt_ms": lambda: host_emit(fetch_records(), threads),
        "fetch_bytes_ms": lambda: fetch_bytes(data, lengths),
        "k6_path_ms": device_path,
    }, EMIT_SPLIT_ROUNDS), "records_bytes": nbytes(rgb, luma), "k6_bytes": nbytes(data, lengths)}
    say(f"  split per batch of {b} (host clock, ms): records fetch "
        f"{split['fetch_records_ms']:.4f} + emit 1 thread {split['emit_1t_ms']:.4f} "
        f"(together {split['records_path_1t_ms']:.4f}), {threads} threads "
        f"{split['emit_mt_ms']:.4f} (together {split['records_path_mt_ms']:.4f}); "
        f"K6 + bytes fetch {split['k6_path_ms']:.4f} (fetch alone "
        f"{split['fetch_bytes_ms']:.4f}) [{CARD}]")
    return split


def emission_check(label: str, rgb: torch.Tensor, luma: torch.Tensor, tbl: torch.Tensor,
                   errs: list[int]) -> None:
    """K6 against its plain version (the whole buffer and the lengths) and
    every frame against the oracle."""
    b = rgb.shape[0]
    data, lengths = emit.emit_truecolor_fg(rgb, luma, tbl)
    want, want_len = emit.emit_truecolor_fg_reference(rgb, luma, tbl)
    torch.cuda.synchronize()
    if not torch.equal(lengths, want_len):
        raise AssertionError(f"{label}: lengths differ from the plain version's")
    check_exact(f"{label} B={b} {tuple(luma.shape[1:])}: whole buffer", data, want, errs)
    host, lens, rgb_h = data.cpu().numpy(), lengths.cpu().numpy(), rgb.cpu().numpy()
    for i in range(b):
        if host[i, :lens[i]].tobytes() != oracle.render_truecolor_fg(rgb_h[i]):
            raise AssertionError(f"{label} frame {i} differs from the oracle")
    say(f"  ok  {label}: {b} frames byte-identical to the oracle "
        f"({lens.min()}-{lens.max()} bytes)")


def old_emit(path: Path):
    """The K6 of ``path``, an earlier ``csrc/emit.cu`` whose
    ``ac_device_emit`` takes no tile-sum scratch (the single-CTA kernel of
    commit dcf0071), built alone with the port's nvcc flags into build/;
    returns a call with :func:`emit.emit_truecolor_fg`'s arguments and results."""
    digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
    out = kernel_build.BUILD_DIR / f"libemit-old-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-o", str(out),
                            str(path)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"build of {path} failed:\n{r.stderr[-4000:]}")
    fn = ctypes.CDLL(str(out)).ac_device_emit
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(rgb, luma, tbl):
        b, h, w, _ = rgb.shape
        worst = emit.worst_bytes(h, w)
        data = torch.empty((b, worst), dtype=torch.uint8, device=rgb.device)
        lengths = torch.empty((b,), dtype=torch.int32, device=rgb.device)
        rc = fn(rgb.data_ptr(), luma.data_ptr(), tbl.data_ptr(), b, h, w, data.data_ptr(), worst,
                lengths.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path}: CUDA error {rc} at launch")
        return data, lengths
    return call


def old_emit_times(path: Path, rgb, luma, tbl) -> dict:
    """The kernel of ``path`` held bit for bit against K6 and timed in turns
    old, new, new, old: device only and eager."""
    old = old_emit(path)
    got, got_len = old(rgb, luma, tbl)
    want, want_len = emit.emit_truecolor_fg(rgb, luma, tbl)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got_len, want_len)):
        raise AssertionError(f"{path}: its bytes differ from K6's")
    new = lambda: emit.emit_truecolor_fg(rgb, luma, tbl)  # noqa: E731
    turns = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        fn = (lambda: old(rgb, luma, tbl)) if name == "old" else new
        turns[name].append({"device_ms": graph_ms(fn), "ms": cuda_ms(fn)})
    say(f"  time K6 in turns old, new, new, old, device only: old "
        f"{fmt([t['device_ms'] for t in turns['old']])} ms, new "
        f"{fmt([t['device_ms'] for t in turns['new']])} ms; eager: old "
        f"{fmt([t['ms'] for t in turns['old']])} ms, new "
        f"{fmt([t['ms'] for t in turns['new']])} ms [{CARD}]")
    return {"source": str(path), **turns}


def phase6c_device_emit(dev, errs: list[int],
                        old_source: Path | None = None) -> tuple[dict, dict[str, int]]:
    say(f"phase 6c: K6 device ANSI emission vs plain and the oracle, batches {EMIT_BATCHES} "
        "of the mirror's truecolor_fg records")
    tbl = torch.from_numpy(emit.ascii_glyph_table())
    sets = emission_records(dev)
    for name, (rgb, luma) in sets.items():
        for b in EMIT_BATCHES:
            emission_check(f"K6 {name}", rgb[:b], luma[:b], tbl, errs)
    rgb, luma = sets["gradient"]
    reset_launches()
    outs = emit.emit_frames_device({"rgb": rgb, "luma": luma})
    launches = read_launches()
    if outs[0] != oracle.render_truecolor_fg(rgb[0].cpu().numpy()):
        raise AssertionError("emit_frames_device frame 0 differs from the oracle")
    k = cuda_ms(lambda: emit.emit_truecolor_fg(rgb, luma, tbl))
    p = cuda_ms(lambda: emit.emit_truecolor_fg_reference(rgb, luma, tbl), iters=5, warmup=1)
    g = graph_ms(lambda: emit.emit_truecolor_fg(rgb, luma, tbl))
    timing(f"K6 {BATCH} x {tuple(luma.shape[1:])}", k, p, g)
    small = {}
    for b in EMIT_BATCHES[:-1]:
        fn = lambda: emit.emit_truecolor_fg(rgb[:b], luma[:b], tbl)  # noqa: E731
        small[str(b)] = {"ms": cuda_ms(fn), "device_ms": graph_ms(fn)}
        say(f"  time K6 {b} x {tuple(luma.shape[1:])}: kernel {small[str(b)]['ms']:.4f} ms "
            f"(device only, CUDA graph: {small[str(b)]['device_ms']:.4f} ms) [{CARD}]")
    old = None if old_source is None else old_emit_times(old_source, rgb, luma, tbl)
    split = emission_split(rgb, luma, tbl)
    data, lengths = emit.emit_truecolor_fg(rgb, luma, tbl)
    b, h, w = luma.shape
    # ops: the SGR compare, three digit counts and the length of a cell
    # (~20) in each launch, the scans, and one staged store per byte of the
    # frames
    ops = 40.0 * luma.numel() + float(lengths.sum())
    need = work(nbytes(rgb, luma), nbytes(data, lengths), ops)
    # what the two launches move besides: the colours read again by the
    # emit launch, and the tile sums written by the first and read by the second
    design = need["bytes"] + nbytes(rgb) + 2 * 4 * b * emit.tiles(h, w)
    entry = dict(ms=k, plain_ms=p, device_ms=g, library_ms=None, split=split,
                 small_batches=small, design_bytes=design,
                 design_bound_ms=design / HBM_BYTES_PER_S * 1e3, **need)
    if old is not None:
        entry["old_single_cta"] = old
    return entry, launches


def phase7_server(dev) -> None:
    say(f"phase 7: server RenderGroup.step, {SERVER_TICKS} ticks")
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    plan = server.plan_tick(sizes, TERM_W, TERM_H, HB_TRUECOLOR)
    grp = server.RenderGroup(sizes, TERM_W, TERM_H, HB_TRUECOLOR, SERVER_FILTERS,
                             device=dev)
    rng = np.random.default_rng(7)
    stacks = [rng.integers(0, 256, (SERVER_SOURCES, UPLINK_H, UPLINK_W, 3),
                           dtype=np.uint8) for _ in range(4)]
    stacks_dev = [torch.from_numpy(s).to(dev) for s in stacks]
    composites = [compositor.composite_reference(s, plan.composite) for s in stacks]
    expected: dict[tuple, bytes] = {}
    r = grp.render

    def tick(t: int) -> list[bytes]:
        records = grp.step(stacks_dev[t % len(stacks)], time_s=100.0 + t / 60)
        host = grp.fetch(records)
        return emitter.emit_frames(host, r.mode, grp.palette, pad_w=r.pad_w,
                                   pad_h=r.pad_h)

    for t in range(SERVER_TICKS):
        time_s = 100.0 + t / 60
        outs = tick(t)
        for c, name in enumerate(SERVER_FILTERS):
            tint = filters.rainbow_color(time_s) if name == "rainbow" else None
            key = (t % len(stacks), name, tint)
            if key not in expected:
                filtered = filters.apply_color_filter_reference(
                    composites[key[0]], name, time_s)
                expected[key] = oracle.ascii_convert_with_capabilities(
                    filtered, TERM_W, 2 * TERM_H, HB_TRUECOLOR)
            if outs[c] != expected[key]:
                raise AssertionError(f"tick {t} receiver {c} ({name}) differs "
                                     "from the oracle")
    say(f"  ok  {SERVER_TICKS} ticks x {len(SERVER_FILTERS)} receivers: "
        "byte-identical to the oracle")
    dev_ms = cuda_ms(lambda: grp.step(stacks_dev[0], time_s=100.0), iters=50)
    t0 = time.perf_counter()
    for t in range(SERVER_TICKS):
        tick(t)
    wall = time.perf_counter() - t0
    say(f"  rate server tick: device {dev_ms:.4f} ms per tick, through D2H + emit "
        f"{SERVER_TICKS / wall:.1f} ticks/s [{CARD}]")


def speech(seed: int, s: int, n: int, ticks: int) -> tuple[np.ndarray, np.ndarray]:
    """samples float32 [ticks, s, n] and active bool [ticks, s] from numpy:
    each source talks in bursts (a tone plus noise at a level between about
    -50 and +2 dBFS, held for 1-5 ticks); ~15% of sources drop out per tick
    and tick 20 has no active source."""
    rng = np.random.default_rng(seed)
    t = np.arange(ticks * n) / audio.SAMPLE_RATE
    samples = np.zeros((s, ticks * n), np.float32)
    for i in range(s):
        tone = np.sin(2 * np.pi * rng.uniform(90, 400) * t) + 0.3 * rng.standard_normal(t.size)
        level = np.zeros(ticks)
        k = 0
        while k < ticks:
            run = int(rng.integers(1, 6))
            level[k:k + run] = rng.choice([0.0, 0.003, 0.02, 0.1, 0.4, 1.2]) * rng.uniform(0.8, 1.1)
            k += run
        samples[i] = tone * np.repeat(level, n)
    active = rng.random((ticks, s)) < 0.85
    active[20 % ticks] = False
    return samples.reshape(s, ticks, n).transpose(1, 0, 2).copy(), active


class AudioErr:
    """Largest absolute error of the mixes against the plain version, and
    largest relative error where the plain value exceeds the absolute
    tolerance (below it the relative error of a value near 0 says nothing),
    over every comparison of a run."""

    def __init__(self):
        self.abs = 0.0
        self.rel = 0.0

    def check(self, label: str, got: torch.Tensor, want: torch.Tensor) -> None:
        d = (got.double() - want.double()).abs()
        if d.numel():
            self.abs = max(self.abs, float(d.max()))
            big = want.double().abs() > AUDIO_TOL["atol"]
            if big.any():
                self.rel = max(self.rel, float((d[big] / want.double().abs()[big]).max()))
        torch.testing.assert_close(got, want, **AUDIO_TOL, msg=lambda m: f"{label}: {m}")


def mixer_run(dev, s: int, ticks: int, exclude_self: bool, seed: int, err: AudioErr,
              n: int = AUDIO_N) -> None:
    """K4 and the plain mixer over ``ticks`` carried ticks of ``n`` samples
    on the card."""
    samples, active = speech(seed, s, n, ticks)
    c = s if exclude_self else 1
    k_state = audio.MixerState.init(s, c, dev).astuple()
    p_state = k_state
    for t in range(ticks):
        x = torch.from_numpy(samples[t]).to(dev)
        act = torch.from_numpy(active[t]).to(dev)
        got, new_k = audio.mixer_process(x, act, k_state, exclude_self=exclude_self)
        want, p_state = audio.mixer_process_reference(x, act, p_state,
                                                      exclude_self=exclude_self)
        label = f"K4 S={s} exclude_self={exclude_self} tick {t}"
        err.check(label, got, want)
        for a, b in zip(new_k, p_state):
            err.check(f"{label} state", a, b)
        if not active[t].any():
            if torch.count_nonzero(got) or not all(torch.equal(a, b)
                                                    for a, b in zip(new_k, k_state)):
                raise AssertionError(f"{label}: an all-silent tick must leave silence "
                                     "and the state untouched")
        k_state = new_k


def mixer_work(s: int, n: int, exclude_self: bool = True) -> dict:
    """K4's bytes (samples and activity in, mixes out, four state vectors
    in and out) and float ops: per sample of each 256-sample frame, 2 per
    source for the full mix and 4 per listener for its mix and peak; per
    output sample ~25 for the compressor gain and the soft clip."""
    c = s if exclude_self else 1
    state = 4 * (2 * s + 2 * c)
    padded = -(-n // audio.MIXER_FRAME_SIZE) * audio.MIXER_FRAME_SIZE
    ops = padded * (2 * s + 4 * c) + 25 * n * c
    return work(4 * s * n + s + state, 4 * c * n + state, float(ops))


def phase9_mixer(dev, err: AudioErr) -> dict:
    s = SERVER_SOURCES
    say(f"phase 9: K4 mixer vs plain mixer_process_reference, {MIXER_TICKS} ticks "
        f"at {s} x {AUDIO_N}")
    mixer_run(dev, s, MIXER_TICKS, True, seed=9, err=err)
    say(f"  ok  {MIXER_TICKS} carried ticks (one all-silent): max abs err {err.abs:.3g}, "
        f"max rel err {err.rel:.3g}")
    for s_, ex in ((s, False), (1, True), (2, True), (32, True)):
        mixer_run(dev, s_, 40, ex, seed=10 + s_, err=err)
        say(f"  ok  S={s_} exclude_self={ex}, 40 ticks")
    for s_ in (s, 32):
        mixer_run(dev, s_, 10, True, seed=50 + s_, err=err, n=4096)
        say(f"  ok  S={s_} exclude_self=True, 10 ticks of 4096 samples")
    samples, active = speech(1, s, AUDIO_N, 1)
    x = torch.from_numpy(samples[0]).to(dev)
    act = torch.from_numpy(active[0] | True).to(dev)
    state = audio.MixerState.init(s, s, dev).astuple()
    k = cuda_ms(lambda: audio.mixer_process(x, act, state), iters=50)
    pl = cuda_ms(lambda: audio.mixer_process_reference(x, act, state), iters=50)
    g = graph_ms(lambda: audio.mixer_process(x, act, state))
    timing(f"K4 {s} x {AUDIO_N}", k, pl, g)
    return dict(ms=k, plain_ms=pl, device_ms=g, library_ms=None, **mixer_work(s, AUDIO_N))


def bounds(t: dict) -> dict:
    """bound_ms, bound_by, roofline_share and, for a gather, sector_floor_ms
    of one kernel's measured times and work."""
    by_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = t["ops"] / FP32_OPS_PER_S * 1e3
    bound = max(by_bytes, by_ops)
    out = {"bytes": t["bytes"], "ops": t["ops"], "bound_ms": bound,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "roofline_share": bound / t["device_ms"]}
    if "sector_bytes" in t:
        floor = t["sector_bytes"] / HBM_BYTES_PER_S * 1e3
        out.update(sector_bytes=t["sector_bytes"], sector_floor_ms=floor,
                   sector_floor_share=floor / t["device_ms"])
        if "cold_device_ms" in t:  # the shares against the time a cold caller sees
            out.update(cold_sector_floor_share=floor / t["cold_device_ms"],
                       cold_roofline_share=bound / t["cold_device_ms"])
    return out


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def read_launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def phase10_server_tick(dev, err: AudioErr) -> dict[str, int]:
    say(f"phase 10: ServerTick.step (K3 + K4), {SERVER_TICKS} ticks")
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    plan = server.plan_tick(sizes, TERM_W, TERM_H, HB_TRUECOLOR)
    tick = server.ServerTick(plan, client_filters=SERVER_FILTERS, device=dev)
    rng = np.random.default_rng(17)
    stacks = [torch.from_numpy(rng.integers(0, 256, (SERVER_SOURCES, UPLINK_H, UPLINK_W, 3),
                                            dtype=np.uint8)).to(dev) for _ in range(3)]
    samples, active = speech(23, SERVER_SOURCES, AUDIO_N, SERVER_TICKS)
    audio_dev = torch.from_numpy(samples).to(dev)
    active_dev = torch.from_numpy(active).to(dev)
    plain_state = tick.mixer_state
    r = plan.render
    geo = dict(mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)
    reset_launches()
    outs = []
    for t in range(SERVER_TICKS):
        records, mixes = tick.step(stacks[t % 3], audio_dev[t], active_dev[t], 100.0 + t / 60)
        # the records are the group's arena, which the next step reuses
        outs.append(({k: v.clone() for k, v in records.items()}, mixes))
    launches = read_launches()
    say(f"  launches over the {SERVER_TICKS} ticks: {launches}")
    for name in (server.RENDER_GROUP_KERNEL.name, audio.MIXER_KERNEL.name):
        if launches[name] == 0:
            raise AssertionError(f"ServerTick.step never launched {name}")
    # the plain tick, replayed on the same inputs: rainbow tint per tick
    g = tick.group
    for t, (records, mixes) in enumerate(outs):
        params = [torch.from_numpy(a).to(dev)
                  for a in filters.filter_params(SERVER_FILTERS, 100.0 + t / 60)]
        want = server.render_compute(stacks[t % 3], g.ramp, *params, g.maps.cidx,
                                     g.maps.src_y, g.maps.src_x, g.maps.comp_mask, **geo)
        if max_abs_err(records, want) != 0:
            raise AssertionError(f"ServerTick tick {t}: records differ from the plain tick")
        want_mix, plain_state = audio.mixer_process_reference(audio_dev[t], active_dev[t],
                                                              plain_state)
        err.check(f"ServerTick tick {t} mixes", mixes, want_mix)
    say(f"  ok  {SERVER_TICKS} ticks x {len(SERVER_FILTERS)} receivers: records exact, "
        f"mixes within rtol=2e-4 atol=2e-5 (max abs err {err.abs:.3g})")
    dev_ms = cuda_ms(lambda: tick.step(stacks[0], audio_dev[0], active_dev[0], 100.0), iters=50)
    say(f"  time ServerTick.step: {dev_ms:.4f} ms per tick (CUDA events, eager) [{CARD}]")
    return launches


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def until(cond, what: str) -> None:
    """Poll ``cond()`` until it holds, or fail after LIVE_WAIT_S."""
    end = asyncio.get_running_loop().time() + LIVE_WAIT_S
    while not cond():
        if asyncio.get_running_loop().time() > end:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


class LiveClient:
    """A raw plaintext ACIP client: a reader task records what arrives."""

    def __init__(self, t, want: bytes):
        self.t = t
        self.want = want
        self.registered = asyncio.Event()  # CLEAR_CONSOLE: caps were taken
        self.matched = asyncio.Event()  # an ASCII_FRAME equal to `want`
        self.frames = 0
        self.mixes = 0
        self.audio_peaks: list[float] = []
        self.task = asyncio.create_task(self._read())

    async def _read(self) -> None:
        while True:
            ptype, payload = await self.t.recv()
            if ptype == pkt.PacketType.CLEAR_CONSOLE:
                self.registered.set()
            elif ptype == pkt.PacketType.ASCII_FRAME:
                self.frames += 1
                if pkt.unpack_ascii_frame(payload)[0] == self.want:
                    self.matched.set()
            elif ptype == pkt.PacketType.AUDIO_BATCH:
                self.mixes += 1
                body, _, total, _, _ = pkt.unpack_audio_batch(payload)
                self.audio_peaks.append(float(np.abs(np.frombuffer(body, "<f4")[:total]).max()))


async def live_session(port: int, pictures: list[np.ndarray], wants: list[bytes]) -> None:
    P = pkt.PacketType
    clients = []
    try:
        for name, want in zip(LIVE_FILTERS, wants):
            t = await connect_tcp("127.0.0.1", port)
            c = LiveClient(t, want)
            clients.append(c)
            wire = proto.WireCapabilities(
                caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                capabilities_mask=0x1,  # no compression: no zstandard needed
                color_filter=filters.FILTER_NAMES.index(name))
            await t.send(P.CLIENT_CAPABILITIES, wire.pack())
            # registered in order, so the composite's source order is known
            await asyncio.wait_for(c.registered.wait(), LIVE_WAIT_S)
        for c, pic in zip(clients, pictures):
            await c.t.send(P.IMAGE_FRAME, pkt.pack_image_frame(pic.tobytes(), UPLINK_W, UPLINK_H))
        for i, c in enumerate(clients):
            try:
                await asyncio.wait_for(c.matched.wait(), LIVE_WAIT_S)
            except TimeoutError:
                raise AssertionError(f"live client {i} ({LIVE_FILTERS[i]}): none of its "
                                     f"{c.frames} frames equals the oracle") from None
        say(f"  ok  {len(clients)} clients: frames byte-identical to the oracle "
            f"({len(wants[0])} bytes each)")
        tone = (0.5 * np.sin(np.arange(AUDIO_N) / 7)).astype("<f4")
        silence = np.zeros(AUDIO_N, "<f4")
        speaker, quiet = clients[0], clients[1]
        end = asyncio.get_running_loop().time() + LIVE_WAIT_S
        # talk until the quiet client has heard the tone and the speaker has
        # had ten mixes of its own (mixes come only while audio arrives)
        while not (any(p > 0.01 for p in quiet.audio_peaks)
                   and len(speaker.audio_peaks) >= 10):
            if asyncio.get_running_loop().time() > end:
                raise AssertionError(f"audio: {len(quiet.audio_peaks)} mixes to the quiet "
                                     f"client, {len(speaker.audio_peaks)} to the speaker, "
                                     "and the tone was not heard")
            await speaker.t.send(P.AUDIO_BATCH, pkt.pack_audio_batch(tone.tobytes(), AUDIO_N, 1))
            await quiet.t.send(P.AUDIO_BATCH, pkt.pack_audio_batch(silence.tobytes(), AUDIO_N, 1))
            await asyncio.sleep(0.01)
        if max(speaker.audio_peaks) >= 1e-6:
            raise AssertionError(f"the speaker hears itself: peak {max(speaker.audio_peaks)}")
        say(f"  ok  exclude-self audio: the quiet client hears the tone (peak "
            f"{max(quiet.audio_peaks):.3f}), the speaker's own mix peaks at "
            f"{max(speaker.audio_peaks):.3g} over {len(speaker.audio_peaks)} mixes")
        # a steady window for the inspector's tick latency and stage split:
        # every source uploads a new picture at LIVE_UPLINK_FPS (so rows of
        # the stack change) and talks at LIVE_AUDIO_HZ (a tone of its own),
        # every receiver takes each tick's frame and each tick's mix
        loop = asyncio.get_running_loop()
        frames0 = [c.frames for c in clients]
        mixes0 = [c.mixes for c in clients]
        voices = [(0.2 * np.sin(np.arange(AUDIO_N) * (0.05 + 0.03 * i))).astype("<f4")
                  for i in range(len(clients))]
        t0 = loop.time()

        async def paced(hz: float, send) -> int:
            k = 0
            while loop.time() - t0 < LIVE_WINDOW_S:
                k += 1
                for i, c in enumerate(clients):
                    await send(i, c, k)
                await asyncio.sleep(max(0.0, t0 + k / hz - loop.time()))
            return k

        async def picture(i, c, k):
            pic = pictures[(i + k) % len(pictures)]
            await c.t.send(P.IMAGE_FRAME, pkt.pack_image_frame(pic.tobytes(), UPLINK_W, UPLINK_H))

        async def voice(i, c, k):
            await c.t.send(P.AUDIO_BATCH, pkt.pack_audio_batch(voices[i].tobytes(), AUDIO_N, 1))

        uploads, batches = await asyncio.gather(paced(LIVE_UPLINK_FPS, picture),
                                                paced(LIVE_AUDIO_HZ, voice))
        took = loop.time() - t0
        rates = [(c.frames - f0) / took for c, f0 in zip(clients, frames0)]
        mix_rates = [(c.mixes - m0) / took for c, m0 in zip(clients, mixes0)]
        say(f"  window {took:.1f} s: {uploads} pictures and {batches} audio batches per "
            f"source; per client per second, frames received "
            f"{[round(r, 1) for r in rates]}, mixes received "
            f"{[round(r, 1) for r in mix_rates]} [{CARD}]")
    finally:
        for c in clients:
            c.task.cancel()
            await c.t.close()


class AppProcess:
    """``python -m asciichat_tpu_torch.apps.main ARGV`` (after ``prelude``'s
    code where one is given) in a subprocess on the card
    (ASCIICHAT_TORCH_DEVICE unset), its output in ``build/LOG_NAME``;
    entered, it waits until the process accepts on ``port``; left on an
    error, it prints the log's tail; it always stops the process."""

    def __init__(self, log_name: str, argv: list[str], port: int, prelude: str = "",
                 env: dict[str, str] | None = None):
        self.port, self.argv, self.prelude = port, argv, prelude
        self.extra_env = env or {}
        self.log_path = ROOT / "build" / log_name
        self.proc = None

    def __enter__(self) -> "AppProcess":
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ)
        env.pop("ASCIICHAT_TORCH_DEVICE", None)  # the default device: the card
        env.update(self.extra_env)
        if self.prelude:  # the code runs first in the process
            cmd = [sys.executable, "-c", self.prelude + "import sys\n"
                   "from asciichat_tpu_torch.apps.main import main\n"
                   f"sys.exit(main({self.argv!r}))\n"]
        else:
            cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", *self.argv]
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=log)
        self.started = time.monotonic()
        try:
            self.wait_accepting(self.port)
            say(f"  {self.argv[0]} accepting after {time.monotonic() - self.started:.1f} s")
        except BaseException:
            self.__exit__(*sys.exc_info())
            raise
        return self

    def wait_accepting(self, port: int) -> None:
        """Wait until the process accepts on ``port``; fail if it exits."""
        t0 = time.monotonic()
        while True:
            self.check()
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                return
            except OSError:
                if time.monotonic() - t0 > LIVE_WAIT_S:
                    raise RuntimeError(f"{self.argv[0]} never accepted on port {port}") from None
                time.sleep(0.1)

    def check(self) -> None:
        if self.proc.poll() is not None:
            raise RuntimeError(f"{self.argv[0]} exited {self.proc.returncode}")

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.proc.kill()
            say(f"  {self.argv[0]} log:\n{self.log_path.read_text(errors='replace')[-4000:]}")
        elif self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


class ServerProcess(AppProcess):
    """``apps.main server`` (with ``extra`` arguments) on a free port, with
    its inspector on another."""

    def __init__(self, log_name: str, *extra: str, prelude: str = "",
                 env: dict[str, str] | None = None):
        port, self.inspect_port = free_port(), free_port()
        super().__init__(log_name, ["server", "--host", "127.0.0.1", "--port", str(port),
                                    "--inspect-port", str(self.inspect_port),
                                    "--log-level", "WARNING", *extra], port, prelude, env)

    def state(self) -> dict:
        """The inspector's /state/server."""
        url = f"http://127.0.0.1:{self.inspect_port}/state/server"
        with urllib.request.urlopen(url, timeout=30) as r:
            return json.loads(r.read())


def phase11_live_server() -> dict[str, int]:
    say("phase 11: live server, python -m asciichat_tpu_torch.apps.main server, "
        f"{len(LIVE_FILTERS)} plaintext TCP clients")
    rng = np.random.default_rng(31)
    pictures = [rng.integers(0, 256, (UPLINK_H, UPLINK_W, 3), dtype=np.uint8)
                for _ in LIVE_FILTERS]
    sizes = [(UPLINK_W, UPLINK_H)] * len(pictures)
    comp = compositor.composite_reference(np.stack(pictures),
                                          compositor.plan_composite(sizes, TERM_W, TERM_H))
    wants = [oracle.ascii_convert_with_capabilities(
        filters.apply_color_filter_reference(comp, name), TERM_W, 2 * TERM_H, HB_TRUECOLOR)
        for name in LIVE_FILTERS]
    with ServerProcess("chip_smoke_server.log") as srv:
        asyncio.run(live_session(srv.port, pictures, wants))
        state = srv.state()
        srv.check()
    bad = []
    if not str(state.get("device", "")).startswith("cuda"):
        bad.append(f"device {state.get('device')!r}")
    if not state.get("tick_compute", 0) > 0:
        bad.append("tick_compute 0")
    for key in ("device_failures", "audio_failures"):
        if state.get(key) != 0:
            bad.append(f"{key} {state.get(key)}")
    for key in ("render_launches", "mixer_launches"):
        if not state.get(key, 0) > 0:
            bad.append(f"{key} {state.get(key)}")
    in_flight = state.get("render_launches", 0) - state.get("tick_compute", 0)
    if state.get("mesh") is not None or not 0 <= in_flight <= 1:
        # one geometry group: one K3 launch for each rendered tick (a tick
        # counts its render after its launch: one may be in flight)
        bad.append(f"mesh {state.get('mesh')}, render_launches {state.get('render_launches')} "
                   f"for tick_compute {state.get('tick_compute')}")
    if bad:
        raise AssertionError(f"inspector /state/server: {'; '.join(bad)}")
    lat, alat = state["tick_latency"], state["audio_tick_latency"]
    LIVE_STAGES["live_server"] = state["tick_stages_ms"]
    say(f"  ok  inspector: device {state['device']}, mesh None, tick_compute "
        f"{state['tick_compute']}, device_failures 0, audio_failures 0, render_launches "
        f"{state['render_launches']} (one a rendered tick), "
        f"mixer_launches {state['mixer_launches']}")
    say(f"  time live server video tick ({lat['n']} ticks): p50 {lat['p50_ms']} ms, "
        f"p99 {lat['p99_ms']} ms, worst {lat['worst_ms']} ms; stages (ms per tick) "
        f"{json.dumps(state['tick_stages_ms'])} [{CARD}]")
    say(f"  time live server audio tick ({alat['n']} ticks): p50 {alat['p50_ms']} ms, "
        f"p99 {alat['p99_ms']} ms, worst {alat['worst_ms']} ms [{CARD}]")
    # a fresh process: its counts ran from 0, and only the server launched
    return {server.RENDER_GROUP_KERNEL.name: state["render_launches"],
            audio.MIXER_KERNEL.name: state["mixer_launches"]}


def capture_scenario(seed: int, frames: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(mic, far) float32 [frames, n] from numpy: far-end noise through a
    two-tap echo path (6 dB down, the Geigel detector's assumption) under a
    noise floor; the path flipped for three frames at a sixth of the run
    (the filter then adds energy: divergence control); near-end speech over
    the echo in the middle third; one frame whose far end arrived half (the
    rest zero, as the pipeline pads an underrun); three silent frames at the
    end, which close the gate."""
    rng = np.random.default_rng(seed)
    total = frames * n
    far = rng.normal(0, 0.2, total).astype(np.float32)
    under = (frames // 2 + 1) * n
    far[under + n // 2:under + n] = 0.0
    path = np.zeros(11, np.float32)
    path[8], path[10] = 0.4, 0.1
    echo = np.convolve(far, path)[:total].astype(np.float32)
    mic = echo + rng.normal(0, 0.02, total).astype(np.float32)
    flip = slice(frames // 6 * n, min(frames // 6 + 3, frames) * n)
    mic[flip] = -echo[flip] + rng.normal(0, 0.02, flip.stop - flip.start).astype(np.float32)
    talk = slice(frames // 3 * n, 2 * frames // 3 * n)
    t = np.arange(total)[talk] / audio.SAMPLE_RATE
    mic[talk] += (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    mic[(frames - 3) * n:] = 0.0
    far[(frames - 3) * n:] = 0.0
    return mic.reshape(frames, n), far.reshape(frames, n)


def capture_state(taps: int, dev) -> tuple:
    """A fresh chain state in capture_chain's order, on ``dev``."""
    z = torch.zeros((), device=dev)
    return (torch.zeros(taps, device=dev), torch.zeros(taps, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev), z, z, z,
            torch.zeros((), dtype=torch.bool, device=dev))


def diverged(state: list, stats: torch.Tensor) -> bool:
    """EchoCanceller.apply_divergence_control on a chain state's weights."""
    dt_frac, out_e, mic_e = stats.tolist()
    if out_e > 2.0 * mic_e + 1e-9:
        state[0] = state[0] * 0.5
        return True
    return False


def capture_run(dev, mic: np.ndarray, far: np.ndarray, err: AudioErr, use_aec: bool = True,
                taps: int = 256) -> int:
    """K5 and the plain chain over the frames with the state carried and
    divergence control between frames, each from its own stats; returns the
    divergence events. Without the AEC every output is held bit for bit."""
    alpha = audio.highpass_alpha(100.0)
    args = dict(CAPTURE_ARGS, use_aec=use_aec, taps=taps)
    k_state = p_state = capture_state(taps if use_aec else 0, dev)
    events = 0
    for t in range(len(mic)):
        m, f = torch.from_numpy(mic[t]).to(dev), torch.from_numpy(far[t]).to(dev)
        got, *k_new, k_stats = audio.capture_chain(m, f, *k_state, alpha, **args)
        want, *p_new, p_stats = audio.capture_chain_reference(m, f, *p_state, alpha, **args)
        label = f"K5 taps={taps} n={len(mic[t])} use_aec={use_aec} frame {t}"
        if use_aec:
            err.check(label, got, want)
            err.check(f"{label} weights", k_new[0], p_new[0])
            exact = [("far_tail", 1), ("hang", 2), ("gate_open", 6)]
        else:
            exact = [("out", None), ("hp_in", 3), ("hp_out", 4), ("gate_env", 5),
                     ("gate_open", 6)]
        for name, i in exact:
            a, b = (got, want) if i is None else (k_new[i], p_new[i])
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {name} differs")
        if not torch.equal(k_stats[0], p_stats[0]):
            raise AssertionError(f"{label}: frozen fraction {k_stats[0]} != {p_stats[0]}")
        k_div, p_div = diverged(k_new, k_stats), diverged(p_new, p_stats)
        if k_div != p_div:
            raise AssertionError(f"{label}: divergence control decided differently")
        events += k_div
        k_state, p_state = tuple(k_new), tuple(p_new)
    return events


def capture_work(taps: int, n: int) -> dict:
    """K5's bytes (mic and far, weights and far tail, the scalar state in;
    output, stats, weights, tail and scalars out) and float ops: per sample
    and tap 9 (w.x and x.x as multiply-adds, the window's |max|, the update's
    multiply, divide and add), per sample ~30 more (reductions' tails, the
    Geigel test, the highpass, the gate)."""
    state = 4 * 2 * taps + 4 * 4 + 1
    return work(4 * 2 * n + state, 4 * (n + 3) + state, float(n * (9 * taps + 30)))


def phase12_capture(dev, err: AudioErr) -> dict:
    n, taps = AUDIO_N, CAPTURE_ARGS["taps"]
    say(f"phase 12: K5 capture chain vs plain capture_chain_reference, {CAPTURE_FRAMES} "
        f"frames at {taps} taps x {n}")
    mic, far = capture_scenario(12, CAPTURE_FRAMES, n)
    events = capture_run(dev, mic, far, err)
    if events < 1:
        raise AssertionError("the flipped echo path made no divergence event")
    say(f"  ok  {CAPTURE_FRAMES} carried frames ({events} divergence events, one underrun): "
        f"max abs err {err.abs:.3g}, max rel err {err.rel:.3g}; far tail, hangover, gate "
        "and frozen fraction exact")
    for n_, frames in ((1, 300), (100, 40), (960, 24)):
        capture_run(dev, *capture_scenario(20 + n_, frames, n_), err)
        say(f"  ok  {frames} frames of {n_} samples")
    for n_, frames in ((480, 30), (1, 200), (100, 30), (960, 12)):
        capture_run(dev, *capture_scenario(40 + n_, frames, n_), err, use_aec=False)
        say(f"  ok  without the AEC, {frames} frames of {n_} samples: bit-exact")
    m, f = (torch.from_numpy(a[0]).to(dev) for a in capture_scenario(3, 1, n))
    state = capture_state(taps, dev)
    alpha = audio.highpass_alpha(100.0)
    k = cuda_ms(lambda: audio.capture_chain(m, f, *state, alpha, **CAPTURE_ARGS), iters=50)
    g = graph_ms(lambda: audio.capture_chain(m, f, *state, alpha, **CAPTURE_ARGS))
    pl = cuda_ms(lambda: audio.capture_chain_reference(m, f, *state, alpha, **CAPTURE_ARGS),
                 iters=3, warmup=1)
    timing(f"K5 {taps} taps x {n}", k, pl, g)
    return dict(ms=k, plain_ms=pl, device_ms=g, library_ms=None, **capture_work(taps, n))


class StillSource:
    """A frame source that shows one picture."""

    def __init__(self, picture: np.ndarray):
        self.picture = picture

    def read(self) -> np.ndarray:
        return self.picture

    def close(self) -> None:
        pass


class LimitedTone:
    """A 440 Hz ToneSource that ends after ``frames`` reads (the client's
    audio task then stops by itself, so every launch has its send)."""

    def __init__(self, frames: int):
        self.tone = ToneSource(440.0, 0.2)
        self.left = frames

    def read(self, n: int) -> np.ndarray:
        if self.left <= 0:
            raise EOFError("the tone is over")
        self.left -= 1
        return self.tone.read(n)

    def close(self) -> None:
        pass


async def live_client_session(port: int, picture: np.ndarray, want: bytes) -> dict:
    """The port's client on the card against the server at ``port``, with a
    raw listener; returns its counts and its capture chain's times."""
    wire = proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                  capabilities_mask=0x1)  # no compression: no zstandard
    client = AsciiChatClient("127.0.0.1", port, StillSource(picture), wire, reconnect=False,
                             audio_source=LimitedTone(CLIENT_AUDIO_FRAMES))
    pipeline = client.audio_pipeline
    if pipeline.device.type != "cuda":
        raise AssertionError(f"the client's capture chain is on {pipeline.device}")
    shown, process_ms = [], []
    client.display = DisplaySink(stream=io.BytesIO())
    client.display.write_frame = lambda frame: shown.append(bytes(frame))
    process = pipeline.process

    def timed(frame):
        t0 = time.perf_counter()
        out = process(frame)
        process_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    pipeline.process = timed
    task = asyncio.create_task(client.run())
    listener = None
    try:
        t = await connect_tcp("127.0.0.1", port)
        listener = LiveClient(t, want)
        await t.send(pkt.PacketType.CLIENT_CAPABILITIES, wire.pack())
        await until(lambda: want in shown, "the live client's frame equal to the oracle")
        await until(lambda: any(p > 0.05 for p in listener.audio_peaks), "the tone")
        # every launch precedes its frame's send: once the last frame is sent
        # (or has failed), the count is final
        await until(lambda: task.done() or client.audio_frames_sent + client.audio_failures
                    >= CLIENT_AUDIO_FRAMES, "the tone's end")
        if task.done():
            task.result()
        client._on_key("q")
        await asyncio.wait_for(task, LIVE_WAIT_S)
    finally:
        if not task.done():
            task.cancel()
        if listener is not None:
            listener.task.cancel()
            await listener.t.close()
    return {"frames_received": client.frames_received, "frames_sent": client.frames_sent,
            "audio_frames_sent": client.audio_frames_sent,
            "audio_failures": client.audio_failures, "heard_peak": max(listener.audio_peaks),
            "matched": shown.count(want), "process_ms": sorted(process_ms)}


def cli_client(port: int, picture: np.ndarray) -> tuple[int, bytes, str]:
    """``apps.main client`` on the card (ASCIICHAT_TORCH_DEVICE unset) with
    ``picture`` fed on stdin until it exits; (exit code, stdout, stderr)."""
    out_path, err_path = ROOT / "build" / "chip_smoke_cli.out", ROOT / "build" / "chip_smoke_cli.err"
    cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "client", "127.0.0.1",
           "--port", str(port), "--stdin-size", f"{UPLINK_W}x{UPLINK_H}", "--no-compress",
           "--no-reconnect", "--max-frames", str(CLI_FRAMES), "--tone-hz", "440",
           "--width", str(TERM_W), "--height", str(TERM_H), "--render-mode", "2",
           "--color-mode", "truecolor", "--log-level", "WARNING"]
    env = dict(os.environ, LANG="C.UTF-8")
    env.pop("ASCIICHAT_TORCH_DEVICE", None)
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=out,
                                stderr=err)

        def feed():
            data = picture.tobytes()
            try:
                while proc.poll() is None:
                    proc.stdin.write(data)
                    proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError):
                pass

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            rc = proc.wait(timeout=2 * LIVE_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            raise
        finally:
            feeder.join(timeout=30)
            try:
                proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass
    return rc, out_path.read_bytes(), err_path.read_text(errors="replace")


def phase13_live_client() -> dict[str, int]:
    say("phase 13: live client, the port's AsciiChatClient on the card against "
        "python -m asciichat_tpu_torch.apps.main server")
    picture = np.random.default_rng(41).integers(0, 256, (UPLINK_H, UPLINK_W, 3), dtype=np.uint8)
    comp = compositor.composite_reference(
        picture[None], compositor.plan_composite([(UPLINK_W, UPLINK_H)], TERM_W, TERM_H))
    want = oracle.ascii_convert_with_capabilities(comp, TERM_W, 2 * TERM_H, HB_TRUECOLOR)
    # the command-line client's stdout is a file: it asks for frames without padding
    piped = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK,
                                 wants_padding=False, utf8_support=True)
    want_cli = oracle.ascii_convert_with_capabilities(comp, TERM_W, 2 * TERM_H, piped)
    with ServerProcess("chip_smoke_client_server.log") as srv:
        reset_launches()
        got = asyncio.run(live_client_session(srv.port, picture, want))
        launches = read_launches()
        srv.check()
        rc, out, err = cli_client(srv.port, picture)
        srv.check()
    k5 = launches[audio.CAPTURE_KERNEL.name]
    if got["audio_failures"] or k5 != got["audio_frames_sent"] or k5 != CLIENT_AUDIO_FRAMES:
        raise AssertionError(f"live client: {k5} K5 launches, {got['audio_frames_sent']} audio "
                             f"frames sent, {got['audio_failures']} failed, expected "
                             f"{CLIENT_AUDIO_FRAMES} of each and none failed")
    pm = got.pop("process_ms")
    say(f"  ok  {got['matched']} of {got['frames_received']} frames byte-identical to the oracle "
        f"({len(want)} bytes); the listener heard the tone (peak {got['heard_peak']:.3f}); "
        f"K5 launches {k5} = audio frames sent, 0 failed")
    say(f"  time ClientAudioPipeline.process ({len(pm)} frames, host clock): p50 "
        f"{pm[len(pm) // 2]:.4f} ms, p99 {pm[int(len(pm) * 0.99)]:.4f} ms, worst {pm[-1]:.4f} ms "
        f"[{CARD}]")
    if rc != 0:
        raise AssertionError(f"CLI client exited {rc}:\n{err[-3000:]}")
    if not out.endswith(want_cli + b"\n"):
        raise AssertionError(f"CLI client: its last frame differs from the oracle "
                             f"({len(out)} bytes out):\n{err[-3000:]}")
    say(f"  ok  CLI client (800x600 on stdin, --tone-hz 440): exit 0 after {CLI_FRAMES} frames, "
        "the last byte-identical to the oracle")
    return launches


@dataclasses.dataclass(frozen=True)
class DitheredCaps(TerminalCapabilities):
    """``16color_dithered``: no terminal capabilities dispatch to it."""

    def renderer_key(self) -> str:
        return "16color_dithered"


def caps_for_mode(mode: str) -> TerminalCapabilities:
    if mode == "16color_dithered":
        return DitheredCaps()
    for color in ColorLevel:
        for render in RenderMode:
            caps = TerminalCapabilities(color, render)
            if caps.renderer_key() == mode:
                return caps
    raise ValueError(mode)


class FrameList:
    """A frame source that plays a fixed list once."""

    def __init__(self, frames: list[np.ndarray]):
        self.frames = list(frames)

    def read(self):
        return self.frames.pop(0) if self.frames else None


def y4m_frames(data: bytes) -> int:
    """Frames of a C444 Y4M stream, checked against its header's size."""
    header, _, body = data.partition(b"\n")
    fields = {f[:1]: f[1:] for f in header.split()[1:]}
    size = 6 + 3 * int(fields[b"W"]) * int(fields[b"H"])
    n, rest = divmod(len(body), size)
    if rest or not all(body[i * size:i * size + 6] == b"FRAME\n" for i in range(n)):
        raise AssertionError(f"Y4M body of {len(body)} bytes is not whole frames of {size}")
    return n


def phase15_render_file(dev) -> tuple[dict[str, int], dict]:
    say(f"phase 15: mirror --render-file, {RF_FRAMES} test-pattern frames at "
        f"{TERM_W}x{TERM_H}, {len(cells.MODES)} modes x {len(RF_PALETTES)} palettes, the card "
        "against the plain CPU version")
    src = TestPatternSource()
    frames = []
    for k in range(RF_FRAMES):
        src._t0 = time.monotonic() - k / 30  # read() at k / 30 s
        frames.append(src.read())
    out_dir = ROOT / "build" / "chip_smoke_render"
    out_dir.mkdir(parents=True, exist_ok=True)
    card_path, cpu_path = out_dir / "card.y4m", out_dir / "cpu.y4m"
    k1_name, k2_name = resize.RESIZE_KERNEL.name, cells.CELL_RECORDS_KERNEL.name
    launches = {k1_name: 0, k2_name: 0}
    for name in RF_PALETTES:
        pal = palette.BUILTIN_PALETTES[name]
        for mode in cells.MODES:
            caps = caps_for_mode(mode)
            reset_launches()
            n = renderfile.render_to_file(FrameList(frames), str(card_path), caps, TERM_W,
                                          TERM_H, pal, max_frames=RF_FRAMES, device=dev)
            got = read_launches()
            renderfile.render_to_file(FrameList(frames), str(cpu_path), caps, TERM_W, TERM_H,
                                      pal, max_frames=RF_FRAMES, device=torch.device("cpu"))
            # a half-block RGB frame's records are two K1 gathers (top and
            # bottom pixel rows); every other mode's are one K2 launch
            k1, k2 = got[k1_name], got[k2_name]
            launches[k1_name] += k1
            launches[k2_name] += k2
            want = (2 * n, 0) if cells.mode_family(mode) == cells.FAM_HB_RGB else (0, n)
            if n != RF_FRAMES or (k1, k2) != want or sum(got.values()) != k1 + k2:
                raise AssertionError(f"render-file {mode}/{name}: {n} frames, launches {got}")
            card, cpu = card_path.read_bytes(), cpu_path.read_bytes()
            if card != cpu:
                at = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b) \
                    if len(card) == len(cpu) else min(len(card), len(cpu))
                raise AssertionError(f"render-file {mode}/{name}: the card's Y4M differs "
                                     f"from the CPU's at byte {at}")
            if y4m_frames(card) != n:
                raise AssertionError(f"render-file {mode}/{name}: {y4m_frames(card)} frames")
            say(f"  ok  {mode} / {name}: {n} frames, {len(card)} bytes of Y4M equal card "
                f"and CPU; launches K1 {k1}, K2 {k2}")
    card_path.unlink()
    cpu_path.unlink()
    times = {mode: render_file_times(dev, frames, mode, out_dir) for mode in RF_TIMED_MODES}
    render_file_cli()
    render_file_mp4(dev, frames, out_dir)
    return launches, times


def render_file_times(dev, frames: list[np.ndarray], mode: str, out_dir: Path) -> dict:
    """One frame's time split on the card (standard palette): upload,
    device (records + raster + YCbCr, CUDA events), fetch and host write
    (host clock), and render_to_file's frames/s over the whole clip."""
    pal = palette.DEFAULT_PALETTE
    caps = caps_for_mode(mode)
    renderer = AsciiRenderer(pal, device=dev)
    host = np.ascontiguousarray(frames[0][None])
    plan = plan_render(host.shape[2], host.shape[1], TERM_W, TERM_H, caps)
    upload_ms = host_ms(lambda: (renderer.to_device(host), torch.cuda.synchronize()))
    frame = renderer.to_device(host)

    def device_part():
        records = renderer.cells_for_plan(frame, plan)
        return renderfile.rgb_to_ycbcr444(renderfile.records_to_pixels(records, mode, pal))

    device_ms = cuda_ms(device_part, iters=30)
    graph_device_ms = graph_ms(device_part)
    ycbcr = device_part()
    # least bytes: each sampled source pixel read once, the YCbCr frame written once
    bound_ms = (plan.dst_h_px * plan.dst_w * 3 + ycbcr.numel()) / HBM_BYTES_PER_S * 1e3
    fetch_ms = host_ms(lambda: ycbcr[0].cpu())
    out = ycbcr[0].cpu().numpy()
    writer = renderfile.Y4MWriter(str(out_dir / "timing.y4m"), out.shape[1], out.shape[0])
    try:
        write_ms = host_ms(lambda: writer.write(out))
    finally:
        writer.close()
    (out_dir / "timing.y4m").unlink()
    path = out_dir / "clip.y4m"
    t0 = time.perf_counter()
    n = renderfile.render_to_file(FrameList(frames), str(path), caps, TERM_W, TERM_H, pal,
                                  max_frames=RF_FRAMES, device=dev)
    wall = time.perf_counter() - t0
    path.unlink()
    fps = n / wall
    share = device_ms / (1e3 / fps)
    say(f"  time render-file {mode} ({out.shape[1]}x{out.shape[0]} px): upload "
        f"{upload_ms:.4f} ms, device (records + raster + YCbCr) {device_ms:.4f} ms eager, "
        f"{graph_device_ms:.4f} ms device only (CUDA graph; bound {bound_ms * 1e3:.2f} us, "
        f"bytes), fetch {fetch_ms:.4f} ms, host write {write_ms:.4f} ms a frame; "
        f"render_to_file {fps:.1f} frames/s ({1e3 / fps:.3f} ms a frame, device {share:.1%} "
        f"of it) [{CARD}]")
    return {"px": [out.shape[1], out.shape[0]], "upload_ms": upload_ms, "device_ms": device_ms,
            "graph_device_ms": graph_device_ms, "bound_ms": bound_ms, "fetch_ms": fetch_ms,
            "write_ms": write_ms, "frames_per_s": fps, "device_share": share}


def render_file_cli() -> None:
    """``apps.main mirror --test-pattern --render-file`` on the card in a
    subprocess (ASCIICHAT_TORCH_DEVICE unset)."""
    out = ROOT / "build" / "chip_smoke.y4m"
    cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "mirror", "--test-pattern",
           "--render-file", str(out), "--max-frames", str(RF_FRAMES)]
    env = dict(os.environ)
    env.pop("ASCIICHAT_TORCH_DEVICE", None)
    t0 = time.monotonic()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, timeout=300)
    took = time.monotonic() - t0
    if r.returncode != 0 or f"rendered {RF_FRAMES} frames".encode() not in r.stdout:
        raise RuntimeError(f"mirror --render-file exited {r.returncode}: {r.stdout[-500:]!r}\n"
                           f"{r.stderr.decode(errors='replace')[-3000:]}")
    n = y4m_frames(out.read_bytes())
    if n != RF_FRAMES:
        raise AssertionError(f"mirror --render-file wrote {n} frames, not {RF_FRAMES}")
    say(f"  ok  CLI {r.stdout.decode().strip()!r}: exit 0, {n} frames in the file "
        f"({took:.1f} s with start-up)")


def render_file_mp4(dev, frames: list[np.ndarray], out_dir: Path) -> None:
    """An .mp4 through NativeRecorder (H.265 on the system libavcodec) where
    the shim loads and an encoder opens; otherwise a line saying why not."""
    path = out_dir / "clip.mp4"
    gh, gw = renderfile.glyph_atlas()[1:]
    try:
        renderfile.NativeRecorder(str(path), TERM_W * gw, TERM_H * gh, 30).close()
    except codecs.CodecUnavailable as e:
        say(f"  .mp4 through NativeRecorder: not run ({e})")
        return
    n = renderfile.render_to_file(FrameList(frames), str(path), FG_TRUECOLOR, TERM_W, TERM_H,
                                  palette.DEFAULT_PALETTE, max_frames=RF_FRAMES, device=dev)
    size = path.stat().st_size
    if n != RF_FRAMES or size == 0:
        raise AssertionError(f".mp4: {n} frames, {size} bytes")
    say(f"  ok  .mp4 through NativeRecorder: {n} frames, {size} bytes")


# The mDNS multicast group inside one process, for the web phase's server:
# each datagram reaches every open socket of the bus, the sender's too, and
# none leaves the process, so the smoke sends nothing onto the machine's
# network. The announcer and the /servers.json sweep run as they are; only
# their socket is this one.
MDNS_BUS = """
import queue, socket, threading
from asciichat_tpu_torch.net import mdns


class _BusSocket:
    def __init__(self, bus):
        self.bus, self.inbox, self.timeout = bus, queue.Queue(), None

    def settimeout(self, timeout):
        self.timeout = timeout

    def sendto(self, data, addr):
        with self.bus.lock:
            for s in self.bus.sockets:
                s.inbox.put((bytes(data), ("127.0.0.1", mdns.MDNS_PORT)))

    def recvfrom(self, n):
        try:
            return self.inbox.get(timeout=self.timeout)
        except queue.Empty:
            raise socket.timeout from None

    def close(self):
        with self.bus.lock:
            self.bus.sockets.remove(self)


class _Bus:
    def __init__(self):
        self.sockets, self.lock = [], threading.Lock()

    def socket(self):
        s = _BusSocket(self)
        with self.lock:
            self.sockets.append(s)
        return s


mdns._mdns_socket = _Bus().socket
mdns._lan_address = lambda: "127.0.0.1"
"""


async def client_session(port: int, picture: np.ndarray, want: bytes, transport: str,
                         **dial) -> dict:
    """The port's client (``use_ws=True`` or ``use_webrtc=True`` in
    ``dial``) against the listener at ``port``, until it shows a frame equal
    to ``want``; it must have dialed a ``transport``."""
    wire = proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                  capabilities_mask=0x1)  # no compression: no zstandard
    client = AsciiChatClient("127.0.0.1", port, StillSource(picture), wire, reconnect=False,
                             **dial)
    shown, dialed = [], []
    client.display = DisplaySink(stream=io.BytesIO())
    client.display.write_frame = lambda frame: shown.append(bytes(frame))
    original_dial = client._dial

    async def recorded_dial():
        t = await original_dial()
        dialed.append(type(t).__name__)
        return t

    client._dial = recorded_dial
    t0 = time.monotonic()
    task = asyncio.create_task(client.run())
    try:
        await until(lambda: want in shown or task.done(), "a frame equal to the oracle")
        if task.done():
            task.result()
        first_match_s = time.monotonic() - t0
        client._on_key("q")
        await asyncio.wait_for(task, LIVE_WAIT_S)
    finally:
        if not task.done():
            task.cancel()
    if dialed != [transport]:
        raise AssertionError(f"the client dialed {dialed}, not {transport}")
    return {"frames_received": client.frames_received, "matched": shown.count(want),
            "first_match_s": first_match_s}


def http_get(port: int, route: str) -> tuple[str, bytes]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
        return r.headers["Content-Type"], r.read()


def http_post_status(port: int, route: str, body: bytes) -> int:
    request = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=body,
                                     method="POST")
    try:
        with urllib.request.urlopen(request, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


# the web phase's server runs as on a machine without `cryptography`: it
# must start, and serve no WebRTC signaling
NO_CRYPTOGRAPHY = "import sys\nsys.modules['cryptography'] = None\n"


def phase16_web() -> dict:
    say("phase 16: web, python -m asciichat_tpu_torch.apps.main server --ws-port --mdns on the "
        "card; the port's AsciiChatClient over WebSocket, the browser page over HTTP")
    picture = np.random.default_rng(51).integers(0, 256, (UPLINK_H, UPLINK_W, 3), dtype=np.uint8)
    comp = compositor.composite_reference(
        picture[None], compositor.plan_composite([(UPLINK_W, UPLINK_H)], TERM_W, TERM_H))
    want = oracle.ascii_convert_with_capabilities(comp, TERM_W, 2 * TERM_H, HB_TRUECOLOR)
    ws_port = free_port()
    web_dir = ROOT / "asciichat_tpu_torch" / "web"
    with ServerProcess("chip_smoke_web_server.log", "--ws-port", str(ws_port), "--mdns",
                       prelude=NO_CRYPTOGRAPHY + MDNS_BUS) as srv:
        srv.wait_accepting(ws_port)  # the WebSocket listener opens after the TCP one
        got = asyncio.run(client_session(ws_port, picture, want, "WebSocketTransport",
                                         use_ws=True))
        srv.check()
        say(f"  ok  AsciiChatClient(use_ws=True): {got['matched']} of {got['frames_received']} "
            f"frames byte-identical to the oracle ({len(want)} bytes)")
        for route, (ctype, name) in web.ASSETS.items():
            got_type, body = http_get(ws_port, route)
            if got_type != ctype or body != (web_dir / name).read_bytes():
                raise AssertionError(f"GET {route}: {got_type}, {len(body)} bytes, not {name}")
        say(f"  ok  GET of {len(web.ASSETS)} routes of web.ASSETS: the port's file bytes")
        # without `cryptography` there is no signaling: a POST is answered as
        # the JAX server answers it without DTLS (net/websocket.serve_ws
        # with no `post` route)
        posts = {route: http_post_status(ws_port, route, b"v=0\r\n")
                 for route in ("/webrtc/offer", "/webrtc/candidate?ufrag=x")}
        if set(posts.values()) != {400}:
            raise AssertionError(f"POST without signaling: {posts}, expected 400")
        say(f"  ok  started without `cryptography`: no WebRTC signaling, POST answered {posts}")
        end = time.monotonic() + LIVE_WAIT_S
        while True:  # the first request starts a 2 s sweep; later ones read its roster
            got_type, body = http_get(ws_port, "/servers.json")
            roster = json.loads(body)
            if got_type != "application/json" or not isinstance(roster, list):
                raise AssertionError(f"/servers.json: {got_type} {body[:200]!r}")
            if roster or time.monotonic() > end:
                break
            time.sleep(0.2)
        mine = {"name": "asciichat", "host": "127.0.0.1", "port": srv.port, "ws": str(ws_port)}
        if roster != [mine]:
            raise AssertionError(f"/servers.json: {roster}, expected [{mine}]")
        say(f"  ok  /servers.json (the server's discover(timeout=2.0) over the in-process "
            f"mDNS bus) found its own announcement: {roster}")
        state = srv.state()
        srv.check()
    if not (str(state.get("device", "")).startswith("cuda") and state.get("render_launches", 0)
            and state.get("device_failures") == 0):
        raise AssertionError(f"inspector /state/server: device {state.get('device')}, render "
                             f"launches {state.get('render_launches')}, device failures "
                             f"{state.get('device_failures')}")
    say(f"  ok  inspector: device {state['device']}, render_launches "
        f"{state['render_launches']}, device_failures 0")
    return {"frames_matched": got["matched"], "assets": len(web.ASSETS), "servers_json": roster,
            "post_without_signaling": posts}


# the discovery host's kernel launches, written when it is asked to stop:
# its standby server is not the one whose inspector a server process has
LAUNCH_DUMP = """
import json, os, signal


def _dump_launches(*_):
    from asciichat_tpu_torch.models.server import RENDER_GROUP_KERNEL
    from asciichat_tpu_torch.ops.audio import MIXER_KERNEL

    with open({path!r}, "w") as f:
        json.dump({{k.name: k.launches for k in (RENDER_GROUP_KERNEL, MIXER_KERNEL)}}, f)
    os._exit(0)


signal.signal(signal.SIGTERM, _dump_launches)
"""


def webrtc_drive(picture: np.ndarray, want: bytes) -> dict[str, int]:
    """The port's client with ``use_webrtc=True`` against ``apps.main
    server --ws-port`` (signaling on ``POST /webrtc/offer``)."""
    ws_port = free_port()
    with ServerProcess("chip_smoke_webrtc_server.log", "--ws-port", str(ws_port)) as srv:
        srv.wait_accepting(ws_port)
        got = asyncio.run(client_session(ws_port, picture, want, "DataChannelTransport",
                                         use_webrtc=True))
        state = srv.state()
        srv.check()
    if not (str(state.get("device", "")).startswith("cuda") and state.get("render_launches", 0)
            and state.get("device_failures") == 0):
        raise AssertionError(f"inspector /state/server: device {state.get('device')}, render "
                             f"launches {state.get('render_launches')}, device failures "
                             f"{state.get('device_failures')}")
    say(f"  ok  AsciiChatClient(use_webrtc=True) over a DataChannel: {got['matched']} of "
        f"{got['frames_received']} frames byte-identical to the oracle, the first "
        f"{got['first_match_s']:.2f} s after the dial began; inspector: device "
        f"{state['device']}, render_launches {state['render_launches']}, device_failures 0")
    # a fresh process: its counts ran from 0, and only the server launched
    return {server.RENDER_GROUP_KERNEL.name: state["render_launches"],
            audio.MIXER_KERNEL.name: state["mixer_launches"]}


async def discovery_viewer(acds_port: int, string: str, picture: np.ndarray,
                           want: bytes) -> dict:
    """Join ``string`` through the discovery service and view the host as
    the ``discovery`` viewer does, at the server tick's full width."""
    from asciichat_tpu_torch.apps.discovery import DiscoverySession

    sess = DiscoverySession("127.0.0.1", acds_port)
    await asyncio.wait_for(sess.connect(), LIVE_WAIT_S)
    try:
        host, port = await asyncio.wait_for(
            sess.join(string, my_address="127.0.0.1", my_port=free_port()), LIVE_WAIT_S)
        wire = proto.WireCapabilities(caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H,
                                      capabilities_mask=0x1)
        client = AsciiChatClient(host, port, StillSource(picture), wire, reconnect=False)
        shown = []
        client.display = DisplaySink(stream=io.BytesIO())
        client.display.write_frame = lambda frame: shown.append(bytes(frame))
        t0 = time.monotonic()
        task = asyncio.create_task(client.run())
        try:
            await until(lambda: want in shown or task.done(), "a frame equal to the oracle")
            if task.done():
                task.result()
            first_match_s = time.monotonic() - t0
            client._on_key("q")
            await asyncio.wait_for(task, LIVE_WAIT_S)
        finally:
            if not task.done():
                task.cancel()
        return {"host": f"{host}:{port}", "frames_received": client.frames_received,
                "matched": shown.count(want), "first_match_s": first_match_s}
    finally:
        await sess.leave()


def discovery_cli_joiner(acds_port: int, string: str, host_port: int) -> None:
    """``apps.main discovery --join --max-frames`` on the card: exit 0 after
    its frames from the host."""
    out_path = ROOT / "build" / "chip_smoke_joiner.out"
    env = dict(os.environ, COLORTERM="truecolor")
    env.pop("ASCIICHAT_TORCH_DEVICE", None)
    with open(out_path, "wb") as out:
        joiner = subprocess.run(
            [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "discovery",
             "--acds", "127.0.0.1", "--acds-port", str(acds_port), "--join", string,
             "--port", str(free_port()), "--max-frames", str(CLI_FRAMES),
             "--width", str(TERM_W), "--height", str(TERM_H), "--log-level", "WARNING"],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.PIPE, timeout=2 * LIVE_WAIT_S)
    body = out_path.read_bytes()
    head = f"session: {string}\nhost: 127.0.0.1:{host_port}\n".encode()
    if joiner.returncode != 0 or not body.startswith(head) or body.count(b"\x1b[") < 1000:
        raise AssertionError(f"discovery --join exited {joiner.returncode}, {len(body)} "
                             f"bytes out:\n{joiner.stderr.decode(errors='replace')[-3000:]}")
    say(f"  ok  discovery --join --max-frames {CLI_FRAMES}: exit 0, {len(body)} bytes of "
        "frames from the host")


def discovery_drive(picture: np.ndarray, want: bytes) -> dict[str, int]:
    """``apps.main discovery-service``, a ``discovery`` host (its standby
    server on the card) and two joiners: the viewer above in this process,
    then ``apps.main discovery --join --max-frames``."""
    acds_port, host_port = free_port(), free_port()
    counts_path = ROOT / "build" / "chip_smoke_discovery_launches.json"
    counts_path.unlink(missing_ok=True)
    acds_argv = ["discovery-service", "--host", "127.0.0.1", "--port", str(acds_port),
                 "--log-level", "WARNING"]
    host_argv = ["discovery", "--acds", "127.0.0.1", "--acds-port", str(acds_port),
                 "--port", str(host_port), "--log-level", "WARNING"]
    with AppProcess("chip_smoke_acds.log", acds_argv, acds_port), \
            AppProcess("chip_smoke_discovery_host.log", host_argv, host_port,
                       prelude=LAUNCH_DUMP.format(path=str(counts_path))) as host:
        end = time.monotonic() + LIVE_WAIT_S
        while not (lines := [line for line in host.log_path.read_text(errors="replace")
                             .splitlines() if line.startswith("session: ")]):
            host.check()
            if time.monotonic() > end:
                raise AssertionError("the discovery host printed no session: line")
            time.sleep(0.1)
        string = lines[0].split(": ", 1)[1]
        say(f"  the host printed its session: line {time.monotonic() - host.started:.1f} s "
            "after its start")
        got = asyncio.run(discovery_viewer(acds_port, string, picture, want))
        say(f"  ok  discovery viewer joined {string!r} (host {got['host']}): {got['matched']} "
            f"of {got['frames_received']} frames byte-identical to the oracle, the first "
            f"{got['first_match_s']:.2f} s after its dial began")
        try:  # the command-line viewer asks for compressed frames
            import zstandard  # noqa: F401
        except ImportError as e:
            say(f"  discovery --join not run: its viewer asks for zstd-compressed frames and "
                f"the `zstandard` package cannot be imported here ({e}); "
                "tests/test_torch_discovery.py runs it on the CPU")
        else:
            discovery_cli_joiner(acds_port, string, host_port)
        host.check()
        host.proc.terminate()  # the prelude writes the launches and exits
        host.proc.wait(timeout=30)
    launches = json.loads(counts_path.read_text())
    if not launches.get(server.RENDER_GROUP_KERNEL.name):
        raise AssertionError(f"the discovery host's standby server launched {launches}")
    say(f"  ok  the host's standby server (on the card): launches {launches}")
    return launches


def phase17_webrtc_discovery() -> dict[str, dict[str, int]]:
    say("phase 17: WebRTC (client --webrtc against server --ws-port) and discovery "
        "(discovery-service, a discovery host, two joiners) on the card")
    try:
        import cryptography  # noqa: F401
    except ImportError as e:
        say(f"  not run: WebRTC and discovery need the `cryptography` package (X25519 and "
            f"Ed25519), which cannot be imported here ({e}); tests/test_torch_webrtc.py, "
            "test_torch_datachannel.py and test_torch_discovery.py run them on the CPU")
        return {}
    from asciichat_tpu_torch.net import dtls

    picture = np.random.default_rng(61).integers(0, 256, (UPLINK_H, UPLINK_W, 3),
                                                 dtype=np.uint8)
    comp = compositor.composite_reference(
        picture[None], compositor.plan_composite([(UPLINK_W, UPLINK_H)], TERM_W, TERM_H))
    want = oracle.ascii_convert_with_capabilities(comp, TERM_W, 2 * TERM_H, HB_TRUECOLOR)
    paths = {}
    if dtls.available():
        paths["webrtc_server"] = webrtc_drive(picture, want)
    else:
        say("  WebRTC not run: the system libssl (OpenSSL 3) does not load here, so the "
            "server serves no signaling")
    paths["discovery_host"] = discovery_drive(picture, want)
    return paths


def mesh_label(clients: int, space: int) -> str:
    return f"{clients}" if space == 1 else f"{clients}x{space}"


def mesh_groups(dev, mesh) -> list[server.RenderGroup]:
    sizes = [(UPLINK_W, UPLINK_H)] * SERVER_SOURCES
    return [server.RenderGroup(sizes, w, h, caps, names, device=dev, mesh=mesh)
            for w, h, caps, names in THREE_GROUPS]


def mesh_renders(dev, stack: torch.Tensor) -> dict:
    """Phase 5b's three groups under each forced mesh against the unsharded
    render: bit for bit over MESH_TICKS ticks, one K3 launch a tick per
    shard with a part, then timed in turns."""
    single, single_arena = mesh_groups(dev, None), server.RecordArena(dev)
    runs = {"single": (single, single_arena)}
    out: dict = {"ticks": MESH_TICKS, "launches_per_tick": {"single": 1}}
    for clients, space in MESH_SHAPES:
        label = mesh_label(clients, space)
        mesh = meshlib.make_mesh(clients * space, space, [dev] * (clients * space))
        groups, arena = mesh_groups(dev, mesh), server.MeshArena(mesh)
        runs[label] = (groups, arena)
        reset_launches()
        got = [arena.fetch(server.render_groups(stack, groups, 100.0 + t / 60, arena))
               for t in range(MESH_TICKS)]
        launches = read_launches()[server.RENDER_GROUP_KERNEL.name]
        shards = len({shard.index for g in groups for shard, _ in g.shard_jobs})
        if launches != shards * MESH_TICKS:
            raise AssertionError(f"mesh {label}: {launches} K3 launches over {MESH_TICKS} "
                                 f"ticks, expected {shards} a tick")
        for t, hosts in enumerate(got):
            wants = single_arena.fetch(server.render_groups(stack, single, 100.0 + t / 60,
                                                            single_arena))
            for g, host, want in zip(groups, hosts, wants):
                if any(not np.array_equal(host[k], want[k]) for k in want):
                    raise AssertionError(f"mesh {label} tick {t} {g.render.mode}: records "
                                         "differ from the unsharded K3 render")
        out["launches_per_tick"][label] = shards
        say(f"  ok  mesh {mesh.shape} on {dev}: {MESH_TICKS} ticks of the 3 groups "
            f"bit-identical to the unsharded render, {shards} K3 launches a tick")

    def tick(groups, arena):
        hosts = arena.fetch(server.render_groups(stack, groups, 100.0, arena))
        for g, host in zip(groups, hosts):
            r = g.render
            emitter.emit_frames(host, r.mode, g.palette, pad_w=r.pad_w, pad_h=r.pad_h)

    order = list(runs) + list(runs)[::-1]  # in turns
    tick_ms: dict[str, list[float]] = {}
    render_ms: dict[str, list[float]] = {}
    device_ms: dict[str, list[float]] = {}
    for label in order:
        groups, arena = runs[label]

        def render():
            return server.render_groups(stack, groups, 100.0, arena)

        tick_ms.setdefault(label, []).append(host_ms(lambda: tick(groups, arena)))
        render_ms.setdefault(label, []).append(cuda_ms(render, iters=50))
        device_ms.setdefault(label, []).append(graph_ms(render))
    out["ticks_per_s"] = {k: [1e3 / v for v in ms] for k, ms in tick_ms.items()}
    out.update(render_ms=render_ms, device_ms=device_ms)
    for label in runs:
        say(f"  time {label}: {fmt(out['ticks_per_s'][label])} ticks/s through the fetch "
            f"and the emitter, render_groups {fmt(render_ms[label])} ms eager, "
            f"{fmt(device_ms[label])} ms device only ({out['launches_per_tick'][label]} K3 "
            f"launches a tick) [{CARD}]")
    return out


async def mesh_session(srv: "ServerProcess", pictures: list[np.ndarray],
                       wants: list[bytes]) -> tuple[dict, dict, float]:
    """LIVE_FILTERS' raw clients get frames equal to the oracle; then a
    steady window where each source uploads at LIVE_UPLINK_FPS. The
    inspector's state before and after the window, and its length."""
    P = pkt.PacketType
    clients = []
    loop = asyncio.get_running_loop()
    try:
        for name, want in zip(LIVE_FILTERS, wants):
            t = await connect_tcp("127.0.0.1", srv.port)
            c = LiveClient(t, want)
            clients.append(c)
            wire = proto.WireCapabilities(
                caps=HB_TRUECOLOR, width=TERM_W, height=TERM_H, capabilities_mask=0x1,
                color_filter=filters.FILTER_NAMES.index(name))
            await t.send(P.CLIENT_CAPABILITIES, wire.pack())
            await asyncio.wait_for(c.registered.wait(), LIVE_WAIT_S)
        for c, pic in zip(clients, pictures):
            await c.t.send(P.IMAGE_FRAME, pkt.pack_image_frame(pic.tobytes(), UPLINK_W, UPLINK_H))
        for i, c in enumerate(clients):
            try:
                await asyncio.wait_for(c.matched.wait(), LIVE_WAIT_S)
            except TimeoutError:
                raise AssertionError(f"mesh client {i} ({LIVE_FILTERS[i]}): none of its "
                                     f"{c.frames} frames equals the oracle") from None
        before = await loop.run_in_executor(None, srv.state)
        t0 = loop.time()
        k = 0
        while loop.time() - t0 < MESH_WINDOW_S:
            k += 1
            for i, c in enumerate(clients):
                pic = pictures[(i + k) % len(pictures)]
                await c.t.send(P.IMAGE_FRAME,
                               pkt.pack_image_frame(pic.tobytes(), UPLINK_W, UPLINK_H))
            await asyncio.sleep(max(0.0, t0 + k / LIVE_UPLINK_FPS - loop.time()))
        after = await loop.run_in_executor(None, srv.state)
        return before, after, loop.time() - t0
    finally:
        for c in clients:
            c.task.cancel()
            await c.t.close()


def query_stacks(pid: int) -> str:
    """``apps.main query PID``: the Python stacks of its report."""
    r = subprocess.run([sys.executable, "-m", "asciichat_tpu_torch.apps.main", "query",
                        str(pid)], cwd=ROOT, capture_output=True, timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"query exited {r.returncode}: "
                             f"{r.stderr.decode(errors='replace')[-2000:]}")
    return json.loads(r.stdout)["pystacks"]


CONFIG_TOML = """[display]
width = 100
stretch = true
color-mode = "none"
[preset.narrow.display]
width = 64
"""


def mono_width(line: bytes) -> int:
    """Columns of a monochrome line, where ESC[Nb repeats the previous
    character N more times."""
    return sum(int(m[1]) if m[1] else 1 for m in re.finditer(rb"\x1b\[(\d+)b|.", line, re.S))


def config_cli() -> subprocess.Popen:
    """``mirror --config build/chip_smoke.toml --preset narrow --snapshot``
    on the card, started in the background."""
    path = ROOT / "build" / "chip_smoke.toml"
    path.write_text(CONFIG_TOML)
    env = dict(os.environ)
    env.pop("ASCIICHAT_TORCH_DEVICE", None)
    cmd = [sys.executable, "-m", "asciichat_tpu_torch.apps.main", "mirror", "--test-pattern",
           "--snapshot", "--height", "12", "--config", str(path), "--preset", "narrow"]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def phase19_mesh(dev, stack: torch.Tensor) -> tuple[dict[str, int], dict]:
    say("phase 19: multi-device serving as forced meshes on the one card, and the rest "
        "of the CLI (--config/--preset, query)")
    t19 = time.monotonic()
    cli = config_cli()
    try:
        report = mesh_renders(dev, stack)
        rng = np.random.default_rng(71)
        pictures = [rng.integers(0, 256, (UPLINK_H, UPLINK_W, 3), dtype=np.uint8)
                    for _ in LIVE_FILTERS]
        sizes = [(UPLINK_W, UPLINK_H)] * len(pictures)
        comp = compositor.composite_reference(
            np.stack(pictures), compositor.plan_composite(sizes, TERM_W, TERM_H))
        wants = [oracle.ascii_convert_with_capabilities(
            filters.apply_color_filter_reference(comp, name), TERM_W, 2 * TERM_H, HB_TRUECOLOR)
            for name in LIVE_FILTERS]
        with ServerProcess("chip_smoke_mesh_server.log",
                           env={"ASCIICHAT_FORCE_MESH": str(MESH_FORCE)}) as srv:
            before, after, took = asyncio.run(mesh_session(srv, pictures, wants))
            stacks = query_stacks(srv.proc.pid)
            srv.check()
        out, err = cli.communicate(timeout=LIVE_WAIT_S)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    # the window's group: the unique filters of LIVE_FILTERS on MESH_FORCE shards
    unique = len(dict.fromkeys(LIVE_FILTERS))
    plan = meshlib.shard_plan(meshlib.make_mesh(MESH_FORCE, devices=[dev] * MESH_FORCE),
                              unique, TERM_H)
    shards = sum(1 for s in plan if s.receivers and s.rows)
    ticks = after["tick_compute"] - before["tick_compute"]
    launches = after["render_launches"] - before["render_launches"]
    bad = []
    if after.get("mesh") != {"clients": MESH_FORCE} or after.get("mesh_collectives") != 0:
        bad.append(f"mesh {after.get('mesh')}, mesh_collectives {after.get('mesh_collectives')}")
    if not str(after.get("device", "")).startswith("cuda") or after.get("device_failures"):
        bad.append(f"device {after.get('device')}, device_failures {after.get('device_failures')}")
    # a tick counts its render after its launches: at each read one tick
    # may be in flight
    if not ticks > 0 or abs(launches - shards * ticks) > shards:
        bad.append(f"{launches} K3 launches over {ticks} rendered ticks, expected {shards} a tick")
    if bad:
        raise AssertionError(f"mesh server inspector: {'; '.join(bad)}")
    lat = after["tick_latency"]
    LIVE_STAGES["server_mesh"] = after["tick_stages_ms"]
    say(f"  ok  server under ASCIICHAT_FORCE_MESH={MESH_FORCE}: {len(LIVE_FILTERS)} clients got "
        f"frames byte-identical to the oracle; inspector mesh {after['mesh']}, "
        f"mesh_collectives 0, device {after['device']}, {launches} K3 launches over {ticks} "
        f"rendered ticks ({shards} a tick) in a {took:.1f} s window")
    say(f"  time mesh server video tick ({lat['n']} ticks): p50 {lat['p50_ms']} ms, p99 "
        f"{lat['p99_ms']} ms, {ticks / took:.1f} rendered ticks/s; convert "
        f"{after['tick_stages_ms'].get('convert')} ms against the unsharded server's "
        f"{LIVE_STAGES.get('live_server', {}).get('convert')} ms (phase 11); stages "
        f"{json.dumps(after['tick_stages_ms'])} [{CARD}]")
    if "hread 0x" not in stacks or "File " not in stacks:
        raise AssertionError(f"query printed no Python stacks: {stacks[:500]!r}")
    say(f"  ok  query {srv.proc.pid}: {stacks.count('hread 0x')} threads' Python stacks "
        f"({len(stacks)} bytes)")
    widths = [mono_width(line) for line in out.rstrip(b"\n").split(b"\n")]
    if cli.returncode != 0 or widths != [64] * 12:
        raise AssertionError(f"mirror --config --preset exited {cli.returncode}, line widths "
                             f"{widths}: {err.decode(errors='replace')[-2000:]}")
    say("  ok  mirror --config build/chip_smoke.toml --preset narrow --snapshot: 12 lines "
        "64 wide (the preset's width over the file's 100)")
    report.update(server={"mesh": after["mesh"], "mesh_collectives": 0, "launches": launches,
                          "rendered_ticks": ticks, "launches_per_tick": shards,
                          "window_s": took, "tick_latency": lat,
                          "tick_stages_ms": after["tick_stages_ms"],
                          "unsharded_tick_stages_ms": LIVE_STAGES.get("live_server")})
    say(f"  phase 19 took {time.monotonic() - t19:.1f} s")
    # a fresh process: its counts ran from 0, and only the server launched
    return {server.RENDER_GROUP_KERNEL.name: after["render_launches"]}, report


def phase20_bench() -> dict:
    say("phase 20: bench, python -m asciichat_tpu_torch.apps.main bench on the card")
    env = dict(os.environ)
    for name in ("ASCIICHAT_BENCH_SMOKE", "ASCIICHAT_TORCH_DEVICE"):
        env.pop(name, None)
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "asciichat_tpu_torch.apps.main", "bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=BENCH_LIMIT_S)
    took = time.monotonic() - t0
    (ROOT / "build" / "chip_smoke_bench.err").write_text(r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"bench exited {r.returncode}:\n{r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines on stdout, not one")
    line = json.loads(lines[0])
    if BENCH_KEYS - set(line) or "smoke" in line:
        raise AssertionError(f"bench keys: missing {BENCH_KEYS - set(line)}, "
                             f"smoke {line.get('smoke')}")
    if "byte-exactness gate: OK" not in r.stderr or not line["value"] > 0:
        raise AssertionError("bench: the byte gate did not pass")
    if not line["server_tick_rate"] > 0:
        raise AssertionError(f"bench: server_tick_rate {line['server_tick_rate']}")
    if line["kernel_fingerprint"] != kernel_build.library_digest():
        raise AssertionError("bench: its kernel fingerprint is not this library's")
    say(f"  bench {lines[0]}")
    say(f"  phase 20 took {took:.1f} s (stderr in build/chip_smoke_bench.err)")
    return line


def soak_run(name: str, seconds: float, uplink_fps: int) -> dict:
    """``tools/torch_soak_<name>.py`` in a subprocess on the card: its JSON
    line, checked for what a short window can show (the cadence gates
    belong to the full-length runs)."""
    env = dict(os.environ, SOAK_UPLINK_FPS=str(uplink_fps))
    env.pop("ASCIICHAT_TORCH_DEVICE", None)
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, str(ROOT / "tools" / f"torch_soak_{name}.py"),
                        str(seconds)], cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                       capture_output=True, text=True, timeout=seconds + SOAK_SLACK_S)
    took = time.monotonic() - t0
    err_log = ROOT / "build" / f"chip_smoke_soak_{name}.err"
    err_log.write_text(r.stderr)
    lines = r.stdout.splitlines()
    if r.returncode not in (0, 1) or len(lines) != 2 or not lines[1].startswith("RESULT:"):
        raise RuntimeError(f"soak {name} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-3000:]}")
    line = json.loads(lines[0])
    bad = []
    if not line["device"].startswith("cuda"):
        bad.append(f"device {line['device']}")
    if "died" in line or "server_tick_error" in line:
        bad.append(f"died {line.get('died')}, tick error {line.get('server_tick_error')}")
    if line["device_failures"]:
        bad.append(f"device_failures {line['device_failures']}")
    if not line["kernel_launches"][server.RENDER_GROUP_KERNEL.name] > 0:
        bad.append("no K3 launch")
    least = (min(line["per_client"].values()) if "per_client" in line
             else line["per_client_min"])
    if least <= 0:
        bad.append("a client got no frames")
    if name == "thirtytwo":
        t33 = line["thirty_third"]
        if not (t33["attempted"] and t33["refused"] and t33.get("still_32")):
            bad.append(f"the 33rd client: {t33}")
    if bad:
        raise AssertionError(f"soak {name}: {'; '.join(bad)}")
    mem = line["device_memory"]
    lag = line["loop_lag_ms"]
    say(f"  ok  soak {name} ({line['seconds']} s, uplink {uplink_fps} fps): "
        f"{line['clients']} clients served, device {line['device']}, device_failures 0"
        + (f", the 33rd refused ({line['thirty_third']['error']})" if name == "thirtytwo"
           else f", {line['churn_joins']} churn cycles, {line['live_resizes']} resizes, "
                f"{line['layout_replans']} replans")
        + f"; {line['kernel_launches']}")
    say(f"  time soak {name}: steady {line['tick_rate_steady']} ticks/s, tick p50 "
        f"{line['latency_p50_ms']} ms, p99 {line['latency_p99_ms']} ms, worst "
        f"{line['latency_worst_ms']} ms; stages {json.dumps(line['stage_avg_ms'])}; "
        f"loop lag p99 {lag.get('p99_ms')} ms; RSS peak {line['rss_peak_kib']} KiB, "
        f"drift {line['rss_postwarmup_drift_kib']} KiB; device memory max "
        f"{mem['max_memory_allocated_bytes']} B, drift allocated "
        f"{mem['allocated_postwarmup_drift_bytes']} B, reserved "
        f"{mem['reserved_postwarmup_drift_bytes']} B; {line['cpu_count']} CPUs "
        f"[{line['card']}] ({took:.1f} s, stderr in {err_log.relative_to(ROOT)})")
    return line


def phase21_soaks() -> tuple[dict[str, dict[str, int]], dict]:
    say("phase 21: the server soaks on the card, tools/torch_soak_nine.py and "
        "tools/torch_soak_thirtytwo.py in subprocesses, short windows")
    paths, lines = {}, {}
    for name, seconds, fps in SOAKS:
        line = soak_run(name, seconds, fps)
        paths[f"soak_{name}"] = line["kernel_launches"]
        lines[name] = {k: line[k] for k in (
            "seconds", "clients", "tick_rate_steady", "latency_p50_ms", "latency_p99_ms",
            "rss_peak_kib", "rss_postwarmup_drift_kib", "device_memory", "card", "ok")}
    return paths, lines


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Drive the port once on one NVIDIA card.")
    parser.add_argument("--k6-old", type=Path, default=None, metavar="PATH",
                        help="an earlier csrc/emit.cu to time against K6 in phase 6c")
    parser.add_argument("--k12-alt", type=Path, default=None, metavar="DIR",
                        help="a directory with another design's resize.cu, cell_records.cu "
                             "and headers (e.g. tools/k12_staged) to time against K1 and K2 "
                             "in phases 3 and 4")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = phase1_device()
    phase2_build()
    frames = make_frames(BATCH, SRC_H, SRC_W, seed=2, device=dev)
    errs: dict[str, list[int]] = {k.name: [] for k in KERNELS}
    shapes = timed_shapes(frames, make_frames(BATCH, WEBCAM_H, WEBCAM_W, seed=4, device=dev),
                          make_frames(BATCH_4K, SRC_4K_H, SRC_4K_W, seed=3, device=dev))
    flush = L2Flush(dev)
    alt = None if args.k12_alt is None else AltK12(args.k12_alt)
    times = {
        "resize_nn": phase3_resize(dev, frames, errs["resize_nn"], shapes, flush, alt),
        "cell_records": phase4_cells(frames, errs["cell_records"], shapes, flush, alt),
    }
    del shapes, flush
    stack = make_frames(SERVER_SOURCES, UPLINK_H, UPLINK_W, seed=5, device=dev)
    times["render_group"] = phase5_group(dev, stack, errs["render_group"])
    times["render_group"]["three_groups"] = phase5b_three_groups(dev, stack,
                                                                 errs["render_group"])
    times["render_group"]["soak_groups"] = phase5c_soak_groups(dev, errs["render_group"])

    paths: dict[str, dict[str, int]] = {}  # path -> kernel -> launches
    reset_launches()
    phase6_mirror(dev, frames)
    paths["mirror"] = read_launches()
    matrix = phase6b_matrix(dev, frames)
    times["device_emit"], paths["device_emit"] = phase6c_device_emit(dev, errs["device_emit"],
                                                                args.k6_old)
    reset_launches()
    phase7_server(dev)
    paths["server_render"] = read_launches()
    say(f"phase 8: launches, each path from its own reset: {paths}")
    need = [("mirror", "resize_nn"), ("mirror", "cell_records"),
            ("server_render", "render_group")]

    mixer_err = AudioErr()
    times["mixer"] = phase9_mixer(dev, mixer_err)
    paths["server_tick"] = phase10_server_tick(dev, mixer_err)
    paths["live_server"] = phase11_live_server()
    capture_err = AudioErr()
    times["capture_chain"] = phase12_capture(dev, capture_err)
    paths["live_client"] = phase13_live_client()
    need += [("server_tick", "render_group"), ("server_tick", "mixer")]
    need += [(path, name) for name, path in MAIN_PATH.items()]
    say(f"phase 14: launches by path: {paths}")
    missing = [f"{name} on {path}" for path, name in need if not paths[path].get(name)]
    if missing:
        raise AssertionError(f"kernels not launched: {missing}")
    paths["render_file"], render_file = phase15_render_file(dev)
    web_check = phase16_web()
    t17 = time.monotonic()
    paths.update(phase17_webrtc_discovery())
    say(f"  phase 17 took {time.monotonic() - t17:.1f} s")
    paths["server_mesh"], mesh = phase19_mesh(dev, stack)
    bench_line = phase20_bench()
    soak_paths, soaks = phase21_soaks()
    paths.update(soak_paths)
    report = {"card": CARD, "kernels": [], "rain": matrix, "render_file": render_file,
              "web": web_check, "mesh": mesh, "bench": bench_line, "soaks": soaks}
    for k in KERNELS:
        entry = {"name": k.name, "route": "cuda", "source": k.source,
                 "replaces": k.replaces, "launches": paths[MAIN_PATH[k.name]][k.name],
                 "launches_by_path": {p: n[k.name] for p, n in paths.items()
                                      if k.name in n}}
        if k in (audio.MIXER_KERNEL, audio.CAPTURE_KERNEL):
            err = mixer_err if k is audio.MIXER_KERNEL else capture_err
            entry.update(max_abs_err=err.abs, max_rel_err=err.rel)
        else:
            entry["max_abs_err"] = max(errs[k.name])
        t = times[k.name]
        entry.update(ms=t["ms"], plain_ms=t["plain_ms"], device_ms=t["device_ms"],
                     **bounds(t), library_ms=t["library_ms"])
        for key in ("cold_device_ms", "flush_ms", "library_device_ms",
                    "library_cold_device_ms", "shapes", "memory_rates", "three_groups",
                    "soak_groups", "split",
                    "small_batches", "design_bytes", "design_bound_ms", "old_single_cta"):
            if key in t:
                entry[key] = t[key]
        report["kernels"].append(entry)
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
