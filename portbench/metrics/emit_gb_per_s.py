"""The native emitter's rate in GB/s (1e9 bytes): the ANSI bytes it wrote in
the traced window (each render.emit.native span's count ``ansi_bytes``) over
the summed time of those spans."""

from harness.program_spans import window_records


def read(run):
    recs = window_records(run, "render.emit.native")
    seconds = sum(r.end_ns - r.start_ns for r in recs or ()) / 1e9
    if seconds <= 0:
        return None
    return sum(r.counts.get("ansi_bytes", 0) for r in recs) / seconds / 1e9
