"""Run the control in the program's place and show that the check fails it.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

For each seed: the cell's frame pool, made on the card as run.py makes it;
a window in which the control (reference/control.py: the reference with
RGB565 pixels) converts the batches in place of ``convert_batch``; then the
same check as run.py's. It prints each seed's compared numbers and exits 0
only if the check failed the control on every seed. The benchmark's own runs
do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import check, frames, spec, window  # noqa: E402
from reference.control import Rgb565Reference  # noqa: E402
from reference.render import Reference  # noqa: E402


def control_verdict(cell: spec.Cell, seed: int, seconds: float, device) -> check.Verdict:
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
                     store, per_call)
    return check.judge(win, expected)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import run
    cell = spec.load_cell(run.ROOT, args.workload, traced=False)
    device = run.find_devices(cell.chips)
    all_failed = True
    for seed in args.seeds:
        v = control_verdict(cell, seed, args.seconds, device)
        all_failed &= not v.correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": v.correct,
                          "attempted": v.attempted, "failed": v.failed,
                          "sampled": v.sampled, "checks": v.checks}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
