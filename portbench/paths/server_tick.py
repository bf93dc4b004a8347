"""The server's video tick: ``AsciiChatServer._render_tick`` of the port.

Set-up builds one server of the port with its defaults on the run's device,
binding no socket, and the configuration's clients, each both a source and a
receiver: a ``ClientState`` with the terminal, mode, palette, filter and
capabilities it would send, streaming, whose transport is a sink that keeps
what the tick sends it. Each client's webcam is a pool of frames made from
the seed (harness/frames.py; a seed of its own for each client) and pinned
in host memory. The traffic advances each client's latest frame to its
pool's next frame every ``advance_every`` ticks, at its ``advance_phase``,
so the tick states repeat every ``advance_every * pool_frames`` ticks.

Each timed call sets the clients' latest frames for its tick state through
``ClientState.video``, calls ``_render_tick`` on them directly and returns
the ASCII_FRAME payload each receiver was sent, in the clients' order (an
empty one where it got none), keeping how many each got and each payload's
header. The warm-up ticks are the states just before the first timed one.
The traced run wraps the tick's upload, its render of every group (K3), the
records' fetch, the emitter and the packing of each payload.

After the window the plain reference (reference/tick.py) makes every state's
frames from the same pools, and ``judge`` holds every tick to it: one
payload to each receiver, each payload's header (the frame's length and
CRC32-C, by harness/acip.py) and length, and a reservoir of ticks, all their
payloads, unpacked and compared byte for byte. The yardstick is K3's least
bytes a tick (harness/yardstick.k3_bytes).
"""

from __future__ import annotations

import contextlib
import os
import random
import time

import torch

from harness import acip, check, frames, program, window, yardstick
from reference.control import rgb565
from reference.tick import TickReference

CALL = "render_tick"
# The calls inside _render_tick that the traced run wraps, in their order.
SPANS = ("upload_stack", "render_groups", "fetch", "emit_frames", "pack_ascii_frame")
ASCII_FRAME = 3000  # packet.h: the packet type of a rendered frame


class Sink:
    """A receiver's transport: keeps each payload it is sent, and an empty
    one for a packet of any other type."""

    def __init__(self):
        self.sent: list[bytes] = []

    def send_nowait(self, ptype, payload=b"", *, byte_cap=None) -> bool:
        self.sent.append(payload if ptype == ASCII_FRAME else b"")
        return True


class Deliveries:
    """What each timed tick delivered beyond its payloads: how many payloads
    each receiver got, and the header of the one returned."""

    def __init__(self):
        self.counts: list[list[int]] = []
        self.headers: list[list[bytes]] = []

    def keep(self, counts: list[int], payloads: list[bytes]) -> None:
        self.counts.append(counts)
        self.headers.append([p[:acip.HEADER.size] for p in payloads])


def tick_states(traffic: dict) -> list[tuple[int, ...]]:
    """The pool frame each client shows in each tick state."""
    every, pool = traffic["advance_every"], traffic["pool_frames"]
    return [tuple((t + phase) // every % pool for phase in traffic["advance_phase"])
            for t in range(every * pool)]


def source_pools(traffic: dict, seed: int, device: torch.device) -> list[torch.Tensor]:
    """Each client's pool of frames, made from a seed drawn from ``seed``."""
    one = dict(traffic, batch=traffic["pool_frames"], pool_batches=1)
    rng = random.Random(f"portbench-sources-{seed}")
    return [frames.make_pool(one, rng.getrandbits(63), device)
            for _ in traffic["advance_phase"]]


def expected_payloads(ref: TickReference, config: dict, states, pools
                      ) -> list[list[tuple[bytes, bytes]]]:
    """(header, frame) of each receiver's payload in each tick state."""
    host = [p.numpy() for p in pools]
    headers: dict[tuple, bytes] = {}
    out = []
    for state in states:
        row = []
        for client, frame in zip(config["clients"],
                                 ref.frames([host[i][k] for i, k in enumerate(state)])):
            key = (frame, client["width"], client["height"])
            if key not in headers:
                headers[key] = acip.header(*key)
            row.append((headers[key], frame))
        out.append(row)
    return out


def judge_ticks(win: window.Window, got: Deliveries,
                expected: list[list[tuple[bytes, bytes]]]) -> check.Verdict:
    """Every tick held to the reference's payloads of its state: each
    receiver sent one payload, with the header and length of the reference's;
    the sampled ticks' payloads unpacked and compared byte for byte. Every
    header is compared whole with the reference's, whose CRC32-C the
    benchmark computed, so an unpacked frame equal to the reference's has
    its CRC. A receiver's payload counts as failed where any of them does
    not hold."""
    n = win.batch_size
    bad: set[tuple[int, int]] = set()
    count_off = header_wrong = length_wrong = 0
    for call, (state, counts, headers, lengths) in enumerate(
            zip(win.batches, got.counts, got.headers, win.lengths)):
        want, lengths = expected[state], lengths.tolist()
        for r in range(n):
            head, frame = want[r]
            miss = abs(counts[r] - 1)
            head_off = headers[r] != head
            length_off = lengths[r] != len(head) + len(frame)
            count_off += miss
            header_wrong += head_off
            length_wrong += length_off
            if miss or head_off or length_off:
                bad.add((call, r))
    sampled = wrong_bytes = 0
    for s in win.samples:
        for pos, row in zip(s.positions, s.rows):
            sampled += 1
            head, frame = expected[s.batch][pos]
            payload = win.store.get(row)
            try:
                ok = payload[:len(head)] == head and acip.unpack(payload)[3] == frame
            except ValueError:
                ok = False
            if not ok:
                wrong_bytes += 1
                bad.add((s.call, pos))
    checks = {
        "payloads_count_off": {"value": count_off, "limit": 0},
        "payload_headers_wrong": {"value": header_wrong, "limit": 0},
        "payloads_wrong_length": {"value": length_wrong, "limit": 0},
        "sampled_payloads_wrong": {"value": wrong_bytes, "limit": 0},
    }
    return check.Verdict(checks, len(win.calls) * n, len(bad), sampled)


class Bench:
    """One server, its clients and their pools, set up and warmed up."""

    def __init__(self, cell, seed: int, device: torch.device, mark):
        conf, traffic = cell.config, cell.traffic
        if len(traffic["advance_phase"]) != len(conf["clients"]):
            raise ValueError("the traffic's sources are not the configuration's clients")
        os.environ["ASCIICHAT_TORCH_DEVICE"] = str(device)
        server = program.load("asciichat_tpu_torch.apps.server")
        protocol = program.load("asciichat_tpu_torch.net.protocol")
        types = program.load("asciichat_tpu_torch.render.types")
        filters = program.load("asciichat_tpu_torch.ops.filters")
        mark("imports and card")
        self.conf, self.traffic = conf, traffic
        self.pools = source_pools(traffic, seed, device)
        self.frames = [[f.numpy() for f in pool] for pool in self.pools]
        mark("frame pools made and pinned")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        self.server = server.AsciiChatServer(palette=conf["palette"],
                                             compression_level=conf["compression_level"])
        # the start-up tuning that AsciiChatServer.run applies before it binds
        # its sockets: the collector's thresholds and the switch interval
        self.server._tune_latency()
        self.clients, self.sinks = [], []
        for i, c in enumerate(conf["clients"]):
            caps = types.TerminalCapabilities(types.ColorLevel[c["color_level"]],
                                              types.RenderMode[c["render_mode"]],
                                              wants_padding=conf["padding"])
            if caps.renderer_key() != c["mode"]:
                raise ValueError(f"{c['name']}: capabilities select {caps.renderer_key()}, "
                                 f"the configuration states {c['mode']}")
            sink = Sink()
            client = server.ClientState(i + 1, sink)
            client.wire_caps = protocol.WireCapabilities(
                caps=caps, width=c["width"], height=c["height"], palette_custom=c["palette"],
                palette_type=5 if c["palette"] else 0,
                color_filter=filters.FILTER_NAMES.index(c["filter"]),
                capabilities_mask=conf["capabilities_mask"])
            client.filter_name = c["filter"]
            client.has_caps = client.streaming = True
            self.clients.append(client)
            self.sinks.append(sink)
        self.shown = [None] * len(self.clients)
        self.tick = self.server._render_tick
        self.states = tick_states(traffic)
        self.batch_size = self.per_call = len(self.clients)
        self.delivered = Deliveries()
        for k in range(traffic["warmup_calls"]):
            self.call(self.states[(k - traffic["warmup_calls"]) % len(self.states)])
            if k == 0:
                mark("first call")
        self.delivered = Deliveries()
        # rows of no width: the store keeps each sampled payload, a bytes
        # object the tick made, by reference and copies nothing
        self.store = window.SampleStore(traffic["sample_calls"] * self.per_call, 0)

    def call(self, state: tuple[int, ...]) -> list[bytes]:
        """One tick in ``state``: each receiver's payload, in order."""
        for i, k in enumerate(state):
            if self.shown[i] != k:
                self.clients[i].video.commit(self.frames[i][k])
                self.shown[i] = k
        self.tick(self.clients)
        counts, payloads = [], []
        for sink in self.sinks:
            counts.append(len(sink.sent))
            payloads.append(sink.sent[0] if sink.sent else b"")
            sink.sent = []
        self.delivered.keep(counts, payloads)
        return payloads

    @contextlib.contextmanager
    def installed(self, spans):
        """Wrap the server's ``_upload_stack`` and its record arena's
        ``fetch`` (on the instances), and ``render_groups`` of apps/server,
        ``emitter.emit_frames`` and ``packet.pack_ascii_frame`` (on their
        modules) for the duration."""
        from asciichat_tpu_torch.apps import server as app
        from asciichat_tpu_torch.net import packet
        from asciichat_tpu_torch.render import emitter
        server, arena = self.server, self.server._arena
        saved = app.render_groups, emitter.emit_frames, packet.pack_ascii_frame
        server._upload_stack = spans.wrap("upload_stack", server._upload_stack)
        arena.fetch = spans.wrap("fetch", arena.fetch)
        app.render_groups = spans.wrap("render_groups", app.render_groups)
        emitter.emit_frames = spans.wrap("emit_frames", emitter.emit_frames)
        packet.pack_ascii_frame = spans.wrap("pack_ascii_frame", packet.pack_ascii_frame)
        try:
            yield
        finally:
            app.render_groups, emitter.emit_frames, packet.pack_ascii_frame = saved
            del server._upload_stack, arena.fetch

    def release(self) -> None:
        """Drop the program's state; the pools stay for the reference."""
        del self.server, self.clients, self.sinks, self.tick

    def judge(self, win: window.Window, say) -> tuple[check.Verdict, int]:
        """The verdict on the window's ticks and K3's least bytes a tick."""
        t = time.perf_counter()
        sizes = [(self.traffic["source_w"], self.traffic["source_h"])] * len(self.pools)
        ref = TickReference(self.conf, sizes)
        expected = expected_payloads(ref, self.conf, self.states, self.pools)
        verdict = judge_ticks(win, self.delivered, expected)
        say(f"portbench: reference {time.perf_counter() - t:.3f} s for {len(self.states)} "
            f"tick states; {len(win.calls)} ticks, {win.frames_returned} payloads in "
            f"{win.seconds:.6f} s; {verdict.sampled} payloads compared byte for byte")
        return verdict, yardstick.k3_bytes(ref)


def control_verdict(cell, seed: int, seconds: float, device: torch.device) -> check.Verdict:
    """The check of a window in which the control (the reference on RGB565
    sources, reference/control.py) sends each tick's payloads in place of
    the server."""
    conf, traffic = cell.config, cell.traffic
    pools = source_pools(traffic, seed, device)
    states = tick_states(traffic)
    sizes = [(traffic["source_w"], traffic["source_h"])] * len(pools)
    ref = TickReference(conf, sizes)
    expected = expected_payloads(ref, conf, states, pools)
    host = [rgb565(p.numpy()) for p in pools]
    payloads = [[acip.header(f, c["width"], c["height"]) + f for c, f in zip(
        conf["clients"], ref.frames([host[i][k] for i, k in enumerate(state)]))]
        for state in states]
    got = Deliveries()

    def control(index):
        sent = payloads[index]
        got.keep([1] * len(sent), sent)
        return sent

    n = len(conf["clients"])
    store = window.SampleStore(traffic["sample_calls"] * n, 0)
    win = window.run(control, range(len(states)), seconds, seed, store, n, n)
    return judge_ticks(win, got, expected)
