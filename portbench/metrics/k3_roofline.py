"""K3's share of its roofline, in %: the least bytes one tick's render of
every group needs (harness/yardstick.k3_bytes) over the HBM peak, against
the summed device time of every kernel launched inside models/server
render_groups, whatever its name, over the traced window."""

from harness.yardstick import HBM_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    seconds = sum(op.dur for op in run.trace.ops
                  if op.kind == "kernel" and op.span == "render_groups") / 1e6
    if seconds <= 0:
        return None
    return 100.0 * len(run.window.calls) * run.records_bytes / HBM_BYTES_PER_S / seconds
