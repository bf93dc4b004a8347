"""The share of the traced window, in %, with no kernel and no copy on the
card while the host is inside the program's span render.emit, its records
mapped onto the device trace's clock (harness/program_spans.py)."""

from harness.program_spans import idle_intervals, on_trace_clock, overlap_us


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops:
        return None
    emits = on_trace_clock(run, "render.emit")
    if emits is None:
        return None
    return 100.0 * overlap_us(idle_intervals(run.trace), emits) / 1e6 / run.trace.window_s
