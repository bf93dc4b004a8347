"""Mean host ms a tick spends in the server's stage tick.fetch (the tick
tracer's span, under server.tick): the one copy of every group's records
into pinned memory, and the wait for the card, K3 with it."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "tick.fetch")
