"""The native emitter's dither rate in millions of cells a second: the cells
it Floyd-Steinberg dithered in the traced window (each render.emit.native
span's count ``dithered_cells``) over the summed time of the spans that
counted them. Nothing where the program counts no such cells."""

from harness.program_spans import window_records


def read(run):
    recs = [r for r in window_records(run, "render.emit.native") or ()
            if r.counts.get("dithered_cells")]
    seconds = sum(r.end_ns - r.start_ns for r in recs) / 1e9
    if seconds <= 0:
        return None
    return sum(r.counts["dithered_cells"] for r in recs) / seconds / 1e6
