"""What may not be loaded where the port is measured.

The benchmark measures the PyTorch port only: no module whose top-level
name (the part before the first dot) is ``jax``, ``jaxlib``, ``flax`` or
the JAX package's may be loaded in its process.  Names are compared whole:
the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ringpop_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
