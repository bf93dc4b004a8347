"""Bytes of every host-to-device copy in the traced window over their summed
device time, in GB/s (1e9 bytes)."""


def read(run):
    if run.trace is None:
        return None
    copies = [op for op in run.trace.ops
              if op.kind == "memcpy" and "HtoD" in op.name and op.bytes]
    seconds = sum(op.dur for op in copies) / 1e6
    if seconds <= 0:
        return None
    return sum(op.bytes for op in copies) / seconds / 1e9
