"""frames_per_s's measure read in the traced run, under the path's wrappers
and the profiler: frames judged right over the window's seconds, where the
host's pace moves too much from run to run for an end-to-end bound."""


def read(run):
    seconds = run.window.seconds
    if seconds <= 0:
        return None
    return (run.verdict.attempted - run.verdict.failed) / seconds
