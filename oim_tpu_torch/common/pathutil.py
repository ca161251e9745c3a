"""Registry key components the port reads and writes
(``oim_tpu/common/pathutil.py``), and the proxy's routing metadata key.

A controller registers ``<id>/address``, its gRPC address, and
``<id>/mesh``, its mesh coordinate; ``parallel.mesh.topology_from_registry``
reads the second. ``serve/...`` and ``telemetry/...`` are the rows a serve
replica and every daemon publish with a lease. The registry's transparent proxy routes a Controller
call to the controller named by the ``controllerid`` request metadata
(``CONTROLLER_ID_META``, ``oim_tpu/registry/registry.py``).
"""

from __future__ import annotations

REGISTRY_ADDRESS = "address"
REGISTRY_MESH = "mesh"
# Top-level namespaces of the rows daemons self-publish with a lease:
# ``serve/<serve-id>`` (a replica's load snapshot, serve/registration.py)
# and ``telemetry/<id>`` (a daemon's metrics endpoint, common/telemetry.py).
REGISTRY_SERVE = "serve"
REGISTRY_TELEMETRY = "telemetry"
CONTROLLER_ID_META = "controllerid"
