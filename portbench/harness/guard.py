"""The modules a run may not load: the JAX stack and the JAX package.

Names are compared by their top-level part, before the first dot, as a whole:
the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "asciichat_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
