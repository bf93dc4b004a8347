"""The batch converter: ``AsciiRenderer.convert_batch`` over a frame pool.

Set-up makes the pool on the card from the seed and pins it in host memory
(harness/frames.py), builds one renderer of the configuration's palette and
makes the traffic's warm-up calls; each timed call converts the pool's next
batch. The traced run wraps the four calls that ``convert_batch`` makes.
After the window the plain reference (reference/render.py) converts every
pool frame and harness/check.py judges the returned frames by count and
length, and a reservoir of them byte for byte. The yardstick is the records'
least bytes a call (harness/yardstick.records_bytes).
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness import check, frames, program, window, yardstick
from reference.control import Rgb565Reference
from reference.render import Reference

CALL = "convert_batch"
# The calls inside convert_batch that the traced run wraps, in their order.
SPANS = ("to_device", "cells_for_plan", "records_to_numpy", "emit_frames")


class Bench:
    """One cell's program, pool and sample store, set up and warmed up."""

    def __init__(self, cell, seed: int, device: torch.device, mark):
        conf, traffic = cell.config, cell.traffic
        pipeline = program.load("asciichat_tpu_torch.render.pipeline")
        types = program.load("asciichat_tpu_torch.render.types")
        mark("imports and card")
        self.conf, self.traffic = conf, traffic
        self.pool = frames.make_pool(traffic, seed, device)
        mark("frame pool made and pinned")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        b = self.batch_size = traffic["batch"]
        self.states = [self.pool[i * b:(i + 1) * b] for i in range(traffic["pool_batches"])]
        self.renderer = pipeline.AsciiRenderer(palette=conf["palette"], device=device)
        caps = types.TerminalCapabilities(types.ColorLevel[conf["color_level"]],
                                          types.RenderMode[conf["render_mode"]],
                                          wants_padding=conf["padding"])
        if caps.renderer_key() != conf["mode"]:
            raise ValueError(f"capabilities select {caps.renderer_key()}, the configuration "
                             f"states {conf['mode']}")
        renderer = self.renderer

        def convert(batch):
            return renderer.convert_batch(batch, conf["width"], conf["height"], caps,
                                          use_aspect_ratio=conf["keep_aspect"])

        self.call = convert
        longest = 0
        for i in range(traffic["warmup_calls"]):
            longest = max([longest, *map(len, convert(self.states[i % len(self.states)]))])
            if i == 0:
                mark("first call")
        self.per_call = traffic["sample_frames_per_call"]
        self.store = window.SampleStore(traffic["sample_calls"] * self.per_call,
                                        longest * 5 // 4)

    @contextlib.contextmanager
    def installed(self, spans):
        """Wrap the renderer's ``to_device`` and ``cells_for_plan`` (on the
        instance) and the pipeline's ``cells.records_to_numpy`` and
        ``emitter.emit_frames`` (on their modules) for the duration."""
        from asciichat_tpu_torch.ops import cells
        from asciichat_tpu_torch.render import emitter
        renderer = self.renderer
        saved = cells.records_to_numpy, emitter.emit_frames
        renderer.to_device = spans.wrap("to_device", renderer.to_device)
        renderer.cells_for_plan = spans.wrap("cells_for_plan", renderer.cells_for_plan)
        cells.records_to_numpy = spans.wrap("records_to_numpy", cells.records_to_numpy)
        emitter.emit_frames = spans.wrap("emit_frames", emitter.emit_frames)
        try:
            yield
        finally:
            cells.records_to_numpy, emitter.emit_frames = saved
            del renderer.to_device, renderer.cells_for_plan

    def release(self) -> None:
        """Drop the program's state; the pool stays for the reference."""
        del self.renderer, self.call

    def judge(self, win: window.Window, say) -> tuple[check.Verdict, int]:
        """The verdict on the window's frames and the yardstick's least bytes a call."""
        t = time.perf_counter()
        traffic = self.traffic
        ref = Reference(self.conf, traffic["source_h"], traffic["source_w"])
        host = self.pool.numpy()
        expected = [ref.frame(host[i]) for i in range(host.shape[0])]
        verdict = check.judge(win, expected)
        say(f"portbench: reference {time.perf_counter() - t:.3f} s for {len(expected)} frames; "
            f"{len(win.calls)} calls, {win.frames_returned} frames in {win.seconds:.6f} s; "
            f"{verdict.sampled} frames compared byte for byte")
        return verdict, yardstick.records_bytes(ref, self.batch_size)


def control_verdict(cell, seed: int, seconds: float, device: torch.device) -> check.Verdict:
    """The check of a window in which the control (reference/control.py: the
    reference with RGB565 pixels) converts the batches in place of
    ``convert_batch``."""
    traffic, conf = cell.traffic, cell.config
    pool = frames.make_pool(traffic, seed, device)
    b = traffic["batch"]
    batches = [pool[i * b:(i + 1) * b].numpy() for i in range(traffic["pool_batches"])]
    control = Rgb565Reference(conf, traffic["source_h"], traffic["source_w"])
    ref = Reference(conf, traffic["source_h"], traffic["source_w"])
    host = pool.numpy()
    expected = [ref.frame(host[i]) for i in range(host.shape[0])]
    per_call = traffic["sample_frames_per_call"]
    store = window.SampleStore(traffic["sample_calls"] * per_call, max(map(len, expected)) * 5 // 4)
    win = window.run(lambda batch: [control.frame(f) for f in batch], batches, seconds, seed,
                     store, per_call, b)
    return check.judge(win, expected)
