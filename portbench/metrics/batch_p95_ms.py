"""The 95th percentile (nearest rank) of the wall time of every convert_batch
call in the traced window: what one caller waits for a batch."""

from harness.record import p95


def read(run):
    return p95(run.call_ms())
