"""Seconds of set-up the program spent building (nvcc, g++) and loading its
kernel libraries: its process-wide totals of the spans kernel.build and
kernel.load, less those that started in the traced window or after it."""

from harness.program_spans import program_trace

SPANS = ("kernel.build", "kernel.load")


def read(run):
    mod = program_trace()
    if mod is None or not run.window.calls:
        return None
    totals = mod.PROCESS.snapshot()
    if not any(name in totals for name in SPANS):
        return None
    start = run.window.calls[0][0]
    later = sum(r.end_ns - r.start_ns for r in mod.records()
                if r.name in SPANS and r.start_ns >= start) / 1e9
    return sum(totals[name][0] for name in SPANS if name in totals) - later
