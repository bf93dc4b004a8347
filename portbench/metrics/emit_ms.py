"""Mean host ms a call spends in render/emitter.emit_frames: the native
emitter's ANSI bytes and one bytes object a frame."""


def read(run):
    return run.span_ms("emit_frames")
