"""Mean host ms of a convert_batch call outside the four wrapped calls
(to_device, cells_for_plan, records_to_numpy, emit_frames): the plan, the
table lookup, the shape check and ``contiguous``."""


def read(run):
    if run.trace is None or not run.window.calls:
        return None
    inside = sum(end - start for _, start, end in run.trace.spans) / 1e6 / len(run.window.calls)
    return sum(run.call_ms()) / len(run.window.calls) - inside
