"""What a benchmark run's ingest did, by the program's own counters.

    python3 tools/portbench_ingest.py OUT.json --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on the card. Runs ``portbench/run.py`` with the
same arguments (its result line and standard error as they are) and writes
to OUT.json the ``render.ingest`` counters of asciichat_tpu_torch over the
whole run (warm-up and window calls): the batches that went to the card as
their sampled rows (``ingest_row_batches``) and whole
(``ingest_whole_batches``), their share, the 2-D row copies and the bytes a
call; with ``--trace 1`` also the window's host-to-device copies from the
device trace: how many, their bytes and device time a call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "portbench"
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from harness import spec  # noqa: E402


def window_copies(r) -> dict | None:
    if r.trace is None:
        return None
    copies = [op for op in r.trace.ops if op.kind == "memcpy" and "HtoD" in op.name]
    calls = len(r.window.calls)
    return {"calls": calls, "htod_copies_per_call": len(copies) / calls,
            "htod_bytes_per_call": sum(op.bytes or 0 for op in copies) / calls,
            "htod_ms_per_call": sum(op.dur for op in copies) / 1e3 / calls}


def ingest_counts() -> dict:
    from asciichat_tpu_torch.utils import trace
    c = {k.removeprefix("render.ingest."): v for k, v in trace.PROCESS.counters().items()
         if k.startswith("render.ingest.")}
    rows, whole = c.get("ingest_row_batches", 0), c.get("ingest_whole_batches", 0)
    calls = rows + whole
    return {"counters": c, "calls": calls,
            "row_path_share": rows / calls if calls else None,
            "bytes_per_call": c.get("bytes", 0) / calls if calls else None}


def main(argv: list[str]) -> int:
    out, args = Path(argv[0]), argv[1:]
    reader = spec.reader
    seen = []

    def hooked(name):
        read = reader(name)

        def first(r):
            if not seen:
                seen.append(window_copies(r))
            return read(r)
        return first

    spec.reader = hooked
    rc = run.main(args)
    out.write_text(json.dumps({"args": args, "rc": rc, "ingest": ingest_counts(),
                               "window_htod": seen[0] if seen else None}, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
