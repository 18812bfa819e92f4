"""What a run may not load: JAX and the JAX package this port comes from.

Module names are compared by their whole top-level name (the part before
the first dot), so the port ``repro_torch`` is not the JAX package
``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names
                   if n.split(".", 1)[0] in FORBIDDEN})
