"""Where the card idles in a traced benchmark window, by the program's own spans.

    python3 tools/portbench_idle_split.py OUT.json --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

from the root of a checkout, on the card. Runs ``portbench/run.py`` with the
same arguments (its result line and standard error as they are) and writes
to OUT.json each stretch of the window with no kernel and no copy on the
card, in seconds, by the innermost span of asciichat_tpu_torch the host was
in (``outside_program_spans`` where it was in none: the caller's loop), both
over the whole window and over the idle gaps that the benchmark's breakdown
puts down to ``emit_frames``. The program's records are mapped onto the
trace's clock by ``portbench/harness/program_spans.clock_fit``.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "portbench"
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from harness import program_spans, spec  # noqa: E402


def idle_split(r) -> dict:
    mod = program_spans.program_trace()
    fit = program_spans.clock_fit(r)
    if mod is None or fit is None:
        return {"error": "the program kept no span records, or no clock fit"}
    lo, hi = r.window.calls[0][0], r.window.calls[-1][1]
    recs = [x for x in mod.records() if lo <= x.start_ns <= hi]
    by_id = {x.id: x for x in recs}

    def depth(x) -> int:
        d = 0
        while x.parent in by_id:
            x, d = by_id[x.parent], d + 1
        return d

    spans = sorted((x.start_ns / 1e3 + fit.offset_us, x.end_ns / 1e3 + fit.offset_us, depth(x),
                    x.name) for x in recs)
    starts = [s[0] for s in spans]
    longest = max((s[1] - s[0] for s in spans), default=0.0)
    total: dict[str, float] = defaultdict(float)
    in_emit: dict[str, float] = defaultdict(float)
    for a, b in program_spans.idle_intervals(r.trace):
        named_by_breakdown = r.trace.host_activity((a + b) / 2)
        j = bisect.bisect_left(starts, a - longest)
        cover = [s for s in spans[j:bisect.bisect_right(starts, b)] if s[1] > a]
        cuts = sorted({a, b, *(min(max(t, a), b) for s in cover for t in s[:2])})
        for x, y in zip(cuts, cuts[1:]):
            inside = [s for s in cover if s[0] <= (x + y) / 2 < s[1]]
            name = max(inside, key=lambda s: s[2])[3] if inside else "outside_program_spans"
            total[name] += (y - x) / 1e6
            if named_by_breakdown == "emit_frames":
                in_emit[name] += (y - x) / 1e6
    return {"calls": len(r.window.calls), "window_s": r.trace.window_s, "busy_s": r.trace.busy_s,
            "clock_fit": vars(fit), "idle_s_by_innermost_span": dict(total),
            "emit_frames_gaps_s_by_innermost_span": dict(in_emit)}


def main(argv: list[str]) -> int:
    out, args = Path(argv[0]), argv[1:]
    reader = spec.reader
    written = []

    def hooked(name):
        read = reader(name)

        def first(r):
            if not written and r.trace is not None:
                out.write_text(json.dumps(idle_split(r), indent=1))
                written.append(out)
            return read(r)
        return first

    spec.reader = hooked
    return run.main(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
