"""Peaks and the work a call must do, counted from the cell's geometry.

The byte count follows the kernels' rule (each sampled source pixel read
once, 3 bytes; each record byte written once), counted for the mode's work
and not for any one kernel, so kernels that are fused, split or renamed are
read against the same count.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 bandwidth at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12


def records_bytes(reference, batch: int) -> int:
    """Least bytes one call's records need: the distinct source pixels that the
    resize samples, read once, and the records written once."""
    read = 3 * np.unique(reference.sy).size * np.unique(reference.sx).size
    rows = -(-reference.pixel_rows // reference.mode.ROWS_PER_CELL)
    write = rows * reference.cells_w * reference.mode.RECORD_BYTES_PER_CELL
    return batch * (read + write)
