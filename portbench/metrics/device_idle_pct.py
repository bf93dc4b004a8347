"""The share of the traced window, in %, with no kernel and no copy on the
card (torch.profiler's device operations, their union)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
