"""Mean host ms a call spends in the program's span render.emit.native: the
native emitter writing a batch's ANSI bytes into its reused buffer."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "render.emit.native")
