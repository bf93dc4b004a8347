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
:func:`mixer_state`, so both packages continue the same trajectory. The
client's capture chain carries its echo canceller's weights and far-end tail,
the hangover, the highpass's last input and output and the gate's envelope
and state: :func:`capture_state` reads them from a capture pipeline and
:func:`load_capture_state` sets them on the port's.
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


# A client capture pipeline's carried state, by name, with the dtype each
# array must have; the first three belong to the echo canceller.
CAPTURE_STATE: dict[str, np.dtype] = {
    "weights": np.dtype(np.float32),
    "far_tail": np.dtype(np.float32),
    "hang": np.dtype(np.int32),
    "hp_in": np.dtype(np.float32),
    "hp_out": np.dtype(np.float32),
    "gate_env": np.dtype(np.float32),
    "gate_open": np.dtype(bool),
}
AEC_STATE = ("weights", "far_tail", "hang")


def capture_state(pipeline, device: torch.device | str) -> dict:
    """The carried state of a ``ClientAudioPipeline`` (the JAX package's, or
    any object with its attributes), read as numpy -> tensors on ``device``
    by CAPTURE_STATE name, plus the echo canceller's ``divergence_resets``.
    Without an echo canceller only the filters' state is read."""
    aec = pipeline.aec
    out: dict = {}
    for name, want in CAPTURE_STATE.items():
        owner = aec if name in AEC_STATE else pipeline
        if owner is None:
            continue
        a = np.asarray(getattr(owner, name))
        if a.dtype != want:
            raise ValueError(f"{name}: dtype {a.dtype}, expected {want}")
        out[name] = torch.from_numpy(np.array(a)).to(device)
    if aec is not None:
        out["divergence_resets"] = int(aec.divergence_resets)
    return out


def load_capture_state(pipeline, state: dict) -> None:
    """Set :func:`capture_state`'s result on the port's ``ClientAudioPipeline``
    (on its device); the far-end FIFO is host data and is not part of it."""
    if (pipeline.aec is None) != ("weights" not in state):
        raise ValueError("the state and the pipeline differ in having an echo canceller")
    for name, value in state.items():
        owner = pipeline.aec if name in AEC_STATE or name == "divergence_resets" else pipeline
        setattr(owner, name, value if name == "divergence_resets"
                else value.to(pipeline.device))
