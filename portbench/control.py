"""Run the control in the program's place and show that the check fails it.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

For each seed, the path of the cell's configuration (``paths/<path>.py``,
its ``control_verdict``) makes the cell's inputs as run.py does, runs a
window in which the control (reference/control.py: the reference with
RGB565 pixels) stands in the program's place, and judges it by the same
check as run.py's. It prints each seed's compared numbers and exits 0 only
if the check failed the control on every seed. The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import run
    cell = spec.load_cell(run.ROOT, args.workload, traced=False)
    device = run.find_devices(cell.chips)
    path = spec.path(cell.config)
    all_failed = True
    for seed in args.seeds:
        v = path.control_verdict(cell, seed, args.seconds, device)
        all_failed &= not v.correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": v.correct,
                          "attempted": v.attempted, "failed": v.failed,
                          "every_frame_wrong": v.failed == v.attempted,
                          "sampled": v.sampled, "checks": v.checks}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
