"""The port must run without JAX or the JAX package.

Names are compared as whole top-level names, the part before the first
dot: `plenum_tpu_torch` is the port and allowed, `plenum_tpu` is not.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "plenum_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))
