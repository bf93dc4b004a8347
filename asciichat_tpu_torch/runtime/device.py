"""Explicit device selection and the checks every kernel wrapper makes.

A tensor on the CPU takes a kernel's plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel or raises. Nothing here falls back
from the card to the CPU.
"""

from __future__ import annotations

import os

import torch

# Device for the command-line entry points: "cuda" (the default) requires a
# card; "cpu" runs the plain PyTorch versions, for machines without one.
DEVICE_ENV = "ASCIICHAT_TORCH_DEVICE"


def require_cuda() -> torch.device:
    """The current CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def default_device() -> torch.device:
    """The device named by ASCIICHAT_TORCH_DEVICE, checked to exist; a CUDA
    device always carries its index ("cuda" is the current card)."""
    name = os.environ.get(DEVICE_ENV, "cuda")
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda" and not name.startswith("cuda:"):
        raise ValueError(f"{DEVICE_ENV}={name!r}: expected cuda, cuda:N or cpu")
    current = require_cuda()
    return current if name == "cuda" else torch.device(name)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor on
    ``device`` whose shape matches ``shape`` (None matches any extent)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.ndim != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
