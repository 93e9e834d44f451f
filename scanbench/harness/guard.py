"""What may not be loaded where the result is printed: JAX, its libraries
and the JAX package beside the port. Top-level module names are compared
whole, since the port's name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "aho_corasick_1975_tpu")
PROGRAM = "aho_corasick_1975_tpu_torch"


def loaded(names=FORBIDDEN, modules=None) -> list:
    """The names of ``names`` that are top-level modules in
    ``modules`` (``sys.modules`` by default)."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                         else modules)}
    return sorted(tops & set(names))
