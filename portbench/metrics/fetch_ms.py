"""Mean host ms a call spends in ops/cells.records_to_numpy: the records'
device-to-host copy into pinned staging, and the wait for the card before it."""


def read(run):
    return run.span_ms("records_to_numpy")
