"""records_roofline (metrics/records_roofline.py) in the cells whose rate is
the card's: there the kernels launched inside cells_for_plan are K2's
(csrc/cell_records.cu)."""

from harness import spec


def read(run):
    return spec.reader("records_roofline")(run)
