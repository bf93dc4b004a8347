"""Carry state across from the JAX package to the port.

This system has no weights. Its parameters are static per-layout and
per-palette arrays: the palette's luma->key ramp (uint8[64]), the composite
gather maps (cidx, src_y, src_x, comp_mask) and the per-receiver filter
vectors (tint, fg_on_bg, is_rainbow, filter_on). :func:`group_arrays` reads
them as numpy from any object that holds them under those names, such as the
JAX package's ``RenderGroup`` (``np.asarray`` of its fields), and
:func:`to_torch` places them on a device, so both packages can compute from
identical state. The audio mixer carries state from tick to tick: its four
float32 vectors (``MixerState.astuple()``, as numpy) go across through
:func:`mixer_state`, so both packages continue the same trajectory.
"""

from __future__ import annotations

import numpy as np
import torch

# The state of a render group, by name, with the dtype each array must have.
GROUP_STATE: dict[str, np.dtype] = {
    "ramp": np.dtype(np.uint8),
    "tint": np.dtype(np.int32),
    "fg_on_bg": np.dtype(bool),
    "is_rainbow": np.dtype(bool),
    "filter_on": np.dtype(bool),
    "cidx": np.dtype(np.int32),
    "src_y": np.dtype(np.int32),
    "src_x": np.dtype(np.int32),
    "comp_mask": np.dtype(bool),
}

# Arrays that stay on the host whatever the device: the ramp and the filter
# vectors ride by value in the kernels' parameters.
HOST_ARRAYS = frozenset({"ramp", "tint", "fg_on_bg", "is_rainbow", "filter_on"})


def group_arrays(group) -> dict[str, np.ndarray]:
    """Every GROUP_STATE array of ``group`` (attributes of those names) as numpy."""
    return {name: np.asarray(getattr(group, name)) for name in GROUP_STATE}


def to_torch(arrays: dict[str, np.ndarray], device: torch.device | str
             ) -> dict[str, torch.Tensor]:
    """Each array as a contiguous tensor of the same dtype on ``device``
    (HOST_ARRAYS on the CPU). Arrays named in GROUP_STATE must already have
    its dtype: a silent cast could hide a mismatch between the packages."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        want = GROUP_STATE.get(name)
        if want is not None and a.dtype != want:
            raise ValueError(f"{name}: dtype {a.dtype}, expected {want}")
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
        out[name] = t if name in HOST_ARRAYS else t.to(device)
    return out


# MixerState.astuple() order; every vector is float32.
MIXER_STATE = ("envelope", "duck_gain", "comp_envelope", "comp_gain")


def mixer_state(state: tuple, device: torch.device | str) -> tuple[torch.Tensor, ...]:
    """A mixer state as four 1-D float32 host arrays in
    ``MixerState.astuple()`` order (e.g. ``np.asarray`` of the JAX package's
    state) -> tensors on ``device``."""
    if len(state) != len(MIXER_STATE):
        raise ValueError(f"mixer state: {len(state)} arrays, expected {len(MIXER_STATE)}")
    out = []
    for name, a in zip(MIXER_STATE, state):
        a = np.asarray(a)
        if a.dtype != np.float32 or a.ndim != 1:
            raise ValueError(f"{name}: {a.dtype} {a.shape}, expected 1-D float32")
        out.append(torch.from_numpy(np.array(a)).to(device))
    return tuple(out)
