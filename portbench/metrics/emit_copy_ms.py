"""Mean host ms a call spends in the program's span render.emit.copy: one
bytes object made a frame from the emitter's buffer."""

from harness.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "render.emit.copy")
