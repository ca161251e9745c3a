"""Registry key components the port reads and writes
(``oim_tpu/common/pathutil.py``), and the proxy's routing metadata key.

A controller registers ``<id>/address``, its gRPC address, and
``<id>/mesh``, its mesh coordinate; ``parallel.mesh.topology_from_registry``
reads the second. ``serve/...`` and ``telemetry/...`` are the rows a serve
replica and every daemon publish with a lease. The registry's transparent proxy routes a Controller
call to the controller named by the ``controllerid`` request metadata
(``CONTROLLER_ID_META``, ``registry/registry.py``). ``alert/...`` and
``fleet/...`` are the SLO plane's and the autoscaler's rows, reserved in
the registry's authorization rules. The path helpers split, join and
prefix-match registry keys as the registry (``registry/``) does.
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
# Top-level namespace for the fleet SLO plane: ``alert/<name>`` -> JSON
# alert body, published TTL-leased by oim-monitor while the SLO's burn
# rate breaches (oim_tpu/obs/monitor.py). Consumers (oimctl --alerts,
# the --top FIRING banner, a future autoscaler) read the lease-filtered
# prefix; a dead monitor's alerts expire with their lease. Reserved like
# ``serve``/``telemetry``: no controller may register under this id.
REGISTRY_ALERT = "alert"
# Top-level namespace for the fleet actuator: ``fleet/<name>`` -> JSON
# desired-state row, published TTL-leased by oim-autoscaler while it
# holds leadership (oim_tpu/autoscale/daemon.py). The lease doubles as
# the leader election: a standby autoscaler defers while the row's
# monotonic beat progresses and claims the key once it freezes or the
# lease lapses. Reserved like ``alert``: writable only by
# ``component.autoscaler``, never registrable as a controller id.
REGISTRY_FLEET = "fleet"


def split_registry_path(path: str) -> list[str]:
    """Split and validate a registry path (reference path.go:25-33)."""
    parts = path.split("/")
    for part in parts:
        if part in ("", ".", ".."):
            raise ValueError(f"invalid registry path: {path!r}")
    return parts


def join_registry_path(parts: list[str] | tuple[str, ...]) -> str:
    """Canonical join; validates components (reference path.go:35-38)."""
    path = "/".join(parts)
    split_registry_path(path)
    return path


def path_has_prefix(path: str, prefix_parts: list[str]) -> bool:
    """Component-wise prefix match: ``a/b`` is under ``a`` but ``ab`` is
    not. The ONE definition of registry prefix semantics — GetValues,
    the DB scan, and lease renewal must all agree on it."""
    return path.split("/")[: len(prefix_parts)] == prefix_parts
