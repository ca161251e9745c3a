"""oim-router: the serving tier's request router / load balancer.

Speaks the same ``oim.v1.Serve`` service as the replicas, so clients
point at the router instead of a replica and nothing else changes. The
routing table is the registry's lease-filtered ``serve/<id>`` rows
(each ``oim-serve --serve-id`` replica heartbeats its endpoint + load
snapshot there): least-loaded pick with a power-of-two-choices
tie-break, pre-first-token retry on the next replica, client
cancel/deadline propagated to the upstream decode slot. Dead replicas
vanish when their lease expires; draining ones announce ``ready: false``
and rotate out a beat earlier.

    oim-router --registry localhost:9421 --endpoint tcp://0.0.0.0:9001
"""

from __future__ import annotations

import argparse
import signal
import threading

from oim_tpu_torch.cli.common import (
    add_common_flags,
    add_observability_flags,
    add_registry_flag,
    load_tls_flags,
    setup_logging,
    start_observability,
    start_telemetry_row,
)
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.router import ReplicaTable, RouterService, router_server


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("oim-router")
    parser.add_argument(
        "--endpoint", default="tcp://0.0.0.0:9001",
        help="listen endpoint clients dial (tcp:// or unix://)",
    )
    add_registry_flag(parser, required=True,
                      help_suffix="source of the serve/<id> replica rows")
    parser.add_argument(
        "--poll-interval", type=float, default=2.0,
        help="seconds between jittered GetValues polls of the replica "
             "table (routing decisions ride the cached view)",
    )
    parser.add_argument(
        "--max-stale", type=float, default=30.0,
        help="how long the last good replica snapshot keeps routing "
             "through a registry outage before the router answers "
             "UNAVAILABLE",
    )
    parser.add_argument(
        "--no-affinity", action="store_true",
        help="disable prefix-affinity routing: ignore the hot-prefix "
             "hashes replicas advertise and pick purely least-loaded "
             "(affinity is otherwise a tie-break within the load guard)",
    )
    parser.add_argument(
        "--affinity-guard", type=int, default=None,
        help="how many requests of extra backlog a prefix-holding "
             "replica may carry and still win the pick over the "
             "least-loaded one (default 2; 0 = affinity only among "
             "equally-loaded replicas)",
    )
    add_common_flags(parser)
    add_observability_flags(parser)
    args = parser.parse_args(argv)
    setup_logging(args)
    log = from_context()
    obs = start_observability(args, "oim-router")

    tls = load_tls_flags(args)
    table = ReplicaTable(
        args.registry,
        interval=args.poll_interval,
        max_stale=args.max_stale,
        tls=tls,
    )
    table.start()
    server = router_server(
        args.endpoint,
        RouterService(table, tls=tls, affinity=not args.no_affinity,
                      affinity_guard=args.affinity_guard),
        tls=tls)
    # "router" works insecure; under mTLS pass --telemetry-id matching
    # the dialing identity's own id (registry authz binds the row name).
    start_telemetry_row(obs, args.telemetry_id or "router", "router",
                        args.registry, tls=tls)
    log.info("oim-router serving", endpoint=args.endpoint,
             addr=server.addr, registry=args.registry,
             replicas=len(table))

    stopping = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    try:
        while not stopping.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    log.info("stopping", replicas=len(table))
    # Graceful: stop taking new streams, let residents finish briefly.
    server.stop(grace=10.0)
    table.stop()
    obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
