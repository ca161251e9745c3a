"""Registry key components the port reads (``oim_tpu/common/pathutil.py``).

A controller registers ``<id>/mesh``, its mesh coordinate, beside
``<id>/address``; ``parallel.mesh.topology_from_registry`` reads the first.
"""

from __future__ import annotations

REGISTRY_MESH = "mesh"
