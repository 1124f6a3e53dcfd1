"""What a run may not have loaded: JAX, its libraries and the JAX package
the measured program was ported from. Modules are compared by their
top-level name, the part before the first dot, as a whole name (the
measured package's name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scrubvae_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    names in ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
