"""Peaks and the work a call must do, counted from the cell's geometry.

The byte count follows the kernels' rule (each sampled source pixel read
once, 3 bytes; each record byte written once), counted for the mode's work
and not for any one kernel, so kernels that are fused, split or renamed are
read against the same count. For the server's tick it is counted from the
reference's maps (reference/tick.py): the distinct source pixels that any
receiver's frame samples, and the records of each distinct frame.
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


def k3_bytes(tick) -> int:
    """Least bytes one tick's render of every group needs: the distinct
    source pixels that the views sample, read once, and the records of each
    view and filter written once (a TickReference's ``views`` and
    ``receivers``)."""
    sampled = np.concatenate([np.stack([v.src, v.sy, v.sx], -1)[v.src >= 0]
                              for v in tick.views.values()])
    read = 3 * np.unique(sampled, axis=0).shape[0]
    write = 0
    for view in {(v.key, name): v for v, name in tick.receivers}.values():
        rows = -(-view.src.shape[0] // view.mode.ROWS_PER_CELL)
        write += rows * view.src.shape[1] * view.mode.RECORD_BYTES_PER_CELL
    return read + write
