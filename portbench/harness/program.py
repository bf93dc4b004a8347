"""The program under test: asciichat_tpu_torch from this checkout."""

from __future__ import annotations

import importlib
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent.parent


def load(module: str) -> ModuleType:
    """``module`` of asciichat_tpu_torch from this checkout, and nowhere else."""
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))
    import asciichat_tpu_torch
    origin = Path(asciichat_tpu_torch.__file__).absolute()
    if ROOT not in origin.parents:
        raise ImportError(f"asciichat_tpu_torch comes from {origin}, not from {ROOT}")
    return importlib.import_module(module)
