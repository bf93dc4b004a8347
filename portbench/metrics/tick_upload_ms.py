"""Mean host ms a tick spends in the server's stage tick.upload (the tick
tracer's span, under server.tick): the stack's advanced rows copied to the
card, without waiting, and the event recorded after them."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "tick.upload")
