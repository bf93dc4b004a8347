"""Mean host ms a tick spends in the server's stage tick.emit (the tick
tracer's span, under server.tick): the native emitter's ANSI frames, one
call a group."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "tick.emit")
