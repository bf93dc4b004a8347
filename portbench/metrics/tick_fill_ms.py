"""Mean host ms a tick spends in the server's stage tick.fill (the tick
tracer's span, under server.tick): copying each advanced source frame into
the pinned source stack, after the wait for the last upload's reads of it."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "tick.fill")
