"""The records' share of their roofline, in %: the least bytes the mode's
records need at these shapes (harness/yardstick.records_bytes) over the HBM
peak, against the summed device time of every kernel launched inside
cells_for_plan, whatever its name, over the traced window."""

from harness.yardstick import HBM_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    seconds = sum(op.dur for op in run.trace.ops
                  if op.kind == "kernel" and op.span == "cells_for_plan") / 1e6
    if seconds <= 0:
        return None
    return 100.0 * len(run.window.calls) * run.records_bytes / HBM_BYTES_PER_S / seconds
