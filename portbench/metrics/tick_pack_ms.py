"""Mean host ms a tick spends in the server's stage tick.pack (the tick
tracer's span, under server.tick): each receiver's ASCII_FRAME payload, its
frame's CRC32-C and header, once a distinct frame."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "tick.pack")
