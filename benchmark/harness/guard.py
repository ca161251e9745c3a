"""What a run may not load: the JAX package, JAX itself, and the wire
libraries the card machine lacks.

Names are compared by their top-level part (before the first dot) whole,
so the port ``oim_tpu_torch`` never matches ``oim_tpu``. The wire
libraries are compared by their dotted prefix (``google.protobuf``, not
every ``google`` package)."""

from __future__ import annotations

import sys

FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "oim_tpu")
FORBIDDEN_PREFIX = ("grpc", "google.protobuf")


def forbidden_modules(names=None) -> list[str]:
    """The loaded module names that a run must not hold, sorted."""
    names = list(sys.modules) if names is None else list(names)
    bad = set()
    for name in names:
        if name.split(".", 1)[0] in FORBIDDEN_TOP:
            bad.add(name)
        elif any(name == p or name.startswith(p + ".") for p in FORBIDDEN_PREFIX):
            bad.add(name)
    return sorted(bad)
