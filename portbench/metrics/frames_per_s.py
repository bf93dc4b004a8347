"""ANSI frames returned by convert_batch in the window and judged right, over
the window's seconds (the first call's start to the last call's end)."""


def read(run):
    seconds = run.window.seconds
    if seconds <= 0:
        return None
    return (run.verdict.attempted - run.verdict.failed) / seconds
