"""Frames judged right over the seconds in the window in which the card was
busy (a kernel, a copy or a set running: the union of the device trace's
operations), from the profile that an untraced run of a cell reporting this
metric takes without the path's wrappers: the frames one card converts a
second of its own time, where enough callers feed it."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    return (run.verdict.attempted - run.verdict.failed) / busy
