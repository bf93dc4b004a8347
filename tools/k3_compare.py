#!/usr/bin/env python3
"""Hold another version of K3 (the server render) against this checkout's on
one card.

    python3 tools/k3_compare.py OLD_TREE

``OLD_TREE`` is the root of another checkout of the repository (for example
an earlier commit unpacked with ``git archive`` under ``build/``). K3's
wrapper changes with its kernel, so each version runs in a process of its
own that imports that tree's ``asciichat_tpu_torch`` and builds that tree's
kernels into that tree's ``build/``, with this file's timing code (from
this checkout's ``chip_smoke.py``) for both. The processes run in turns:
old, new, new, old.

1. Bit for bit: ``chip_smoke.py`` phase 5's input (9 sources of 800x600 ->
   203x64, half-block truecolor and 256-colour, the server's 9 filters, the
   rainbow tint at 1.25 s), ``RenderGroup.step`` of each version; every
   record must be equal, else the exit code is 1.
2. Time, per version and turn, at phase 5's half-block truecolor group:
   ``render_group`` (the wrapper around one launch) device only (20 calls
   replayed from one CUDA graph) and eager (CUDA events); ``step`` eager;
   ``step`` then ``fetch`` on the host's clock; and one tick of phase 5b's
   three groups the way each version serves it (this checkout: one
   ``render_groups`` and one fetch; a version without ``render_groups``: a
   ``step`` and a ``fetch`` per group), device only, eager and fetched.

The last line of standard output is one JSON object with the results.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIME_S = 1.25


def measure(tree: Path, out: Path) -> None:
    """In a process of its own: the records and times of ``tree``'s K3."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("k3_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # this checkout's helpers over the tree's package
    import torch

    from asciichat_tpu_torch.models import server
    from asciichat_tpu_torch.runtime import kernel_build

    if not Path(server.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {server.__file__}, not {tree}'s package")
    dev = cs.require_cuda()
    kernel_build.cuda_lib()
    stack = cs.make_frames(cs.SERVER_SOURCES, cs.UPLINK_H, cs.UPLINK_W, seed=5, device=dev)
    sizes = [(cs.UPLINK_W, cs.UPLINK_H)] * cs.SERVER_SOURCES
    records = {}
    for caps in (cs.HB_TRUECOLOR, cs.FG_256):
        grp = server.RenderGroup(sizes, cs.TERM_W, cs.TERM_H, caps, cs.SERVER_FILTERS,
                                 device=dev)
        for name, t in grp.step(stack, TIME_S).items():
            records[f"{grp.render.mode}/{name}"] = t.cpu().numpy()
    np.savez(out.with_suffix(".npz"), **records)

    grp = server.RenderGroup(sizes, cs.TERM_W, cs.TERM_H, cs.HB_TRUECOLOR,
                             cs.SERVER_FILTERS, device=dev)
    grp.step(stack, TIME_S)
    r = grp.render

    def bare():
        return server.render_group(stack, grp.ramp, grp.tint, grp.fg_on_bg, grp.is_rainbow,
                                   grp.filter_on, grp.maps, mode=r.mode, dst_h=r.dst_h_px,
                                   dst_w=r.dst_w)

    groups = [server.RenderGroup(sizes, w, h, caps, names, device=dev)
              for w, h, caps, names in cs.THREE_GROUPS]
    if hasattr(server, "render_groups"):
        tick_arena = server.RecordArena(dev)

        def three():
            return server.render_groups(stack, groups, TIME_S, tick_arena)

        def three_fetched():
            tick_arena.fetch(three())

        def three_device():
            return three()
    else:
        def three():
            return [g.step(stack, TIME_S) for g in groups]

        def three_fetched():
            for g in groups:
                g.fetch(g.step(stack, TIME_S))

        def three_device():  # the launches alone: the old step uploads the rainbow tint
            return [server.render_group(stack, g.ramp, g.tint, g.fg_on_bg, g.is_rainbow,
                                        g.filter_on, g.maps, mode=g.render.mode,
                                        dst_h=g.render.dst_h_px, dst_w=g.render.dst_w)
                    for g in groups]

    times = {
        "render_group_device_ms": cs.graph_ms(bare),
        "render_group_ms": cs.cuda_ms(bare, iters=50),
        "step_ms": cs.cuda_ms(lambda: grp.step(stack, TIME_S), iters=50),
        "step_fetch_ms": cs.host_ms(lambda: grp.fetch(grp.step(stack, TIME_S))),
        "three_groups_device_ms": cs.graph_ms(three_device),
        "three_groups_ms": cs.cuda_ms(three, iters=50),
        "three_groups_fetch_ms": cs.host_ms(three_fetched),
    }
    out.write_text(json.dumps(times))


def first_difference(old: dict, new: dict):
    for key in sorted(set(old) | set(new)):
        if key not in old or key not in new:
            return {"record": key, "missing_in": "old" if key not in old else "new"}
        a, b = old[key], new[key]
        if a.shape != b.shape or not np.array_equal(a, b):
            idx = np.argwhere(a != b)[0].tolist() if a.shape == b.shape else None
            return {"record": key, "index": idx, "shapes": [a.shape, b.shape]}
    return None


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--measure":
        measure(Path(argv[1]).resolve(), Path(argv[2]))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.phase1_device()
    trees = {"old": Path(argv[0]).resolve(), "new": ROOT}
    runs: dict[str, list[dict]] = {"old": [], "new": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("old", "new", "new", "old")):
            out = Path(tmp) / f"{i}-{name}.json"
            r = subprocess.run([sys.executable, __file__, "--measure", str(trees[name]),
                                str(out)], cwd=trees[name], capture_output=True, text=True,
                               timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"{name} ({trees[name]}) failed:\n{r.stderr[-4000:]}")
            runs[name].append(json.loads(out.read_text()))
            if i < 2:
                runs[f"{name}_records"] = dict(np.load(out.with_suffix(".npz")))
        diff = first_difference(runs.pop("old_records"), runs.pop("new_records"))
    bits = {"identical": diff is None, **({"first_difference": diff} if diff else {})}
    cs.say(f"K3 old ({argv[0]}) vs new (this checkout): records {json.dumps(bits)}")
    for key in runs["old"][0]:
        for name in ("old", "new"):
            values = [run[key] for run in runs[name]]
            cs.say(f"  time {name} {key}: {', '.join(f'{v:.5f}' for v in values)} "
                   f"(median {statistics.median(values):.5f}) [{cs.CARD}]")
    cs.say(json.dumps({"card": cs.CARD, "bits": bits, "times": runs}))
    return 0 if diff is None else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
