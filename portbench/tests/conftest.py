"""Helpers of the benchmark's CPU tests: a checkout with tiny cells, and a
way to drive run.py in it on the CPU (its look for a card replaced), with a
fault planted under the timed path where a test asks for one."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

TINY_TRAFFIC = {
    "source_w": 80, "source_h": 48, "batch": 4, "pool_batches": 3,
    "loop": "closed, one caller", "warmup_calls": 1,
    "sample_calls": 64, "sample_frames_per_call": 2,
    "content": {"gradient_amplitude": 90.0, "gradient_cycles": [1.5, 1.0, 2.0],
                "gradient_drift": 0.01, "noise_sigma": 3.0, "chunk_frames": 5,
                "discs": [{"radius": 0.2, "speed": 3.0, "colour": [214, 48, 39]},
                          {"radius": 0.1, "speed": 1.5, "colour": [37, 99, 235]}]},
}
# tiny cell -> (its configuration, the cell it stands for)
TINY_CELLS = {"tiny.tc": ("truecolor-203x64", "truecolor.1080p"),
              "tiny.hb": ("halfblock-203x64", "halfblock.1080p")}
# The server's tick at a tiny size: 3 clients of 64x48 in 3 geometry groups.
TINY_TICK_TRAFFIC = {
    "source_w": 64, "source_h": 48, "pool_frames": 4, "advance_every": 2,
    "advance_phase": [0, 1, 1], "loop": "closed, one caller", "warmup_calls": 2,
    "sample_calls": 16, "content": TINY_TRAFFIC["content"],
}
TINY_CLIENTS = [
    {"name": "a", "width": 60, "height": 20, "color_level": "TRUECOLOR",
     "render_mode": "HALF_BLOCK", "mode": "halfblock_truecolor", "palette": "", "filter": "none"},
    {"name": "b", "width": 40, "height": 12, "color_level": "TRUECOLOR",
     "render_mode": "FOREGROUND", "mode": "truecolor_fg", "palette": " .:#@", "filter": "green"},
    {"name": "c", "width": 50, "height": 16, "color_level": "COLOR_256",
     "render_mode": "HALF_BLOCK", "mode": "halfblock_256", "palette": "", "filter": "orange"},
]

# Run by ``python -c`` in a checkout: run.py with the CPU for a card, and with
# argv[1] naming the fault planted in AsciiRenderer.convert_batch or in the
# server's tick.
RUN_ON_CPU = r'''
import sys
import torch
sys.path.insert(0, "portbench")
import run
run.find_devices = lambda chips: torch.device("cpu")
fault = sys.argv[1]
if fault.startswith("tick_"):
    from asciichat_tpu_torch.apps import server
    from asciichat_tpu_torch.net import packet
    device_part, upload, pack = (server.AsciiChatServer._render_tick_device,
                                 server.AsciiChatServer._upload_stack, packet.pack_ascii_frame)
    if fault == "tick_receiver_dropped":  # one receiver left out of the tick
        server.AsciiChatServer._render_tick_device = (
            lambda self, receivers, *a, **k: device_part(self, receivers[:-1], *a, **k))
    elif fault == "tick_sent_twice":  # every payload of the tick sent twice
        def twice(self, *a, **k):
            device_part(self, *a, **k)
            device_part(self, *a, **k)
        server.AsciiChatServer._render_tick_device = twice
    elif fault == "tick_stale_source":  # advanced sources never reach the device
        server.AsciiChatServer._upload_stack = (
            lambda self, changed, fresh: upload(self, [], fresh))
    elif fault == "tick_byte_altered":  # one byte of each frame altered before packing
        def altered(frame, *a, **k):
            frame = bytearray(frame)
            frame[len(frame) // 2] ^= 1
            return pack(bytes(frame), *a, **k)
        packet.pack_ascii_frame = altered
elif fault != "none":
    from asciichat_tpu_torch.render import pipeline
    convert = pipeline.AsciiRenderer.convert_batch
    state = {"n": 0}

    def broken(self, *args, **kwargs):
        frames = convert(self, *args, **kwargs)
        state["n"] += 1
        if fault == "stale":  # the previous call's frames: state returned unchanged
            frames, state["prev"] = state.get("prev", frames), frames
        elif fault == "half":  # half of the batch left out
            frames = frames[:len(frames) // 2]
        elif fault == "half_repeated":  # half left out, the rest returned twice
            frames = frames[:len(frames) // 2] * 2
        elif fault == "altered":  # one byte of one frame altered where it is made
            i = state["n"] % len(frames)
            frame = bytearray(frames[i])
            frame[len(frame) // 2] ^= 1
            frames[i] = bytes(frame)
        return frames

    pipeline.AsciiRenderer.convert_batch = broken
sys.exit(run.main(sys.argv[2:]))
'''


def make_tree(dest: Path, with_program: bool = True) -> Path:
    """A checkout at ``dest``: BENCHMARK.json with the tiny cells added, a copy
    of portbench/ and, where asked, the program (a link to this one)."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH_DIR, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    traffic = dest / "portbench" / "traffic"
    (traffic / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (traffic / "tiny.tick.json").write_text(json.dumps(TINY_TICK_TRAFFIC))
    def config(name: str, **changes) -> dict:
        return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text()) | changes

    # (cell, its configuration, the cell it stands for, its traffic, the configuration's file)
    cells = [(cell, f"tiny-{conf}", like, "tiny", config(conf, width=40, height=12))
             for cell, (conf, like) in TINY_CELLS.items()]
    cells.append(("tiny.tick", "tiny-server", "server9.grid", "tiny.tick",
                  config("server-9", clients=TINY_CLIENTS)))
    for cell, name, like, mix, conf in cells:
        (dest / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "tiny", "reduced": [], "why": "tests",
                                 "file": f"portbench/configs/{name}.json"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": mix,
                                   "chips": 1, "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    if with_program:
        os.symlink(REPO / "asciichat_tpu_torch", dest / "asciichat_tpu_torch")
    return dest


def drive(tree: Path, args: list[str], fault: str = "none", timeout: float = 240):
    """-> (exit code, the result line's dict or None, stderr)."""
    proc = subprocess.run([sys.executable, "-c", RUN_ON_CPU, fault, *args], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = None
    if lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    return proc.returncode, result, proc.stderr


@pytest.fixture(scope="session")
def tree(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("checkout"))
