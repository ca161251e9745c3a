"""oim-registry daemon (reference cmd/oim-registry/main.go).

Runs standalone (the reference's shape), as half of a replicated
primary/standby pair (``--peer`` + ``--role``; registry/replication.py)
— the primary streams its journal to the standby, the standby serves
reads and auto-promotes when the primary's self-lease expires — or as
one member of a raft-style 3+ node quorum (``--quorum`` +
``--advertise``; registry/quorum.py): randomized-timeout leader
election, writes acknowledged only once a majority holds them, and
partition failover with no human in the loop. ``--healthz-port``
serves ``GET /healthz`` for k8s liveness/readiness probes.
"""

from __future__ import annotations

import argparse
import threading

from oim_tpu_torch.cli.common import (
    add_common_flags,
    add_observability_flags,
    load_tls_flags,
    setup_logging,
    start_observability,
)
from oim_tpu_torch.registry import MemRegistryDB, RegistryService
from oim_tpu_torch.registry.db import FileRegistryDB
from oim_tpu_torch.registry.registry import registry_server
from oim_tpu_torch.registry.replication import HealthzServer, ReplicationManager


def _local_telemetry_row(service, manager, telemetry_id: str,
                         metrics_endpoint: str, interval: float = 10.0):
    """The registry's own ``telemetry/<id>`` row, written straight into
    its DB+lease table (same write-lock discipline as SetValue, journaled
    to the standby when replicated) — the one daemon that must not dial
    itself to self-describe, and a standby must not write at all (its
    rows arrive over the replication stream). Returns a stop callable."""
    from oim_tpu_torch.common.telemetry import telemetry_key, telemetry_snapshot

    key = telemetry_key(telemetry_id)
    lease = 2.5 * interval
    stop = threading.Event()

    def loop():
        beats = 0
        while True:
            if manager is None or manager.is_primary:
                beats += 1
                value = telemetry_snapshot("registry", metrics_endpoint,
                                           beat=beats)
                with service._write_lock:
                    # Through the committed-mutation funnel (Watch
                    # streams see the registry's own row too); in
                    # quorum mode record_kv journals it fire-and-forget
                    # and the commit re-applies idempotently.
                    service.apply_kv(key, value, lease)
                    if service.replication is not None:
                        service.replication.record_kv(key, value, lease)
            if stop.wait(interval):
                return

    threading.Thread(target=loop, name="oim-registry-telemetry",
                     daemon=True).start()
    return stop.set


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("oim-registry")
    parser.add_argument(
        "--endpoint", default="tcp://0.0.0.0:8999", help="listen endpoint"
    )
    parser.add_argument(
        "--db-file", default="",
        help="journal the KV DB to this file (survives restarts; default "
             "is the reference's soft-state in-memory DB)",
    )
    parser.add_argument(
        "--boot-grace-seconds", type=float, default=150.0,
        help="lease granted to controller keys replayed from --db-file at "
             "startup (and to lease-less controller keys at standby "
             "promotion): live controllers renew within one heartbeat, "
             "dead ones expire after the grace instead of living forever "
             "(lease state itself cannot survive a restart); 0 disables",
    )
    parser.add_argument(
        "--peer", default="",
        help="peer registry endpoint(s) for replication (comma-separated); "
             "unset runs standalone",
    )
    parser.add_argument(
        "--role", choices=("primary", "standby"), default="primary",
        help="initial replication role (requires --peer); the boot-time "
             "peer probe overrides it when the peer holds a higher "
             "promotion epoch (a rejoining old primary demotes itself)",
    )
    parser.add_argument(
        "--quorum", default="",
        help="comma-separated FULL member list (3+ addresses, this "
             "node included) for raft-style quorum replication: leader "
             "election, majority-acknowledged writes, automatic "
             "partition failover (registry/quorum.py); mutually "
             "exclusive with --peer",
    )
    parser.add_argument(
        "--advertise", default="",
        help="with --quorum: this node's own entry in the member list "
             "(its advertised host:port)",
    )
    parser.add_argument(
        "--election-timeout-seconds", type=float, default=1.0,
        help="with --quorum: base leader-election timeout; followers "
             "campaign after a randomized [T, 2T) silence, the leader "
             "steps down after 2T without majority contact",
    )
    parser.add_argument(
        "--primary-lease-seconds", type=float, default=10.0,
        help="the primary's self-lease over the replication stream: the "
             "standby auto-promotes when no record arrives for this long; "
             "0 disables auto-promotion (oimctl --promote only)",
    )
    parser.add_argument(
        "--healthz-port", type=int, default=0,
        help="serve k8s probes on this port: GET /healthz (readiness: 200 "
             "when serving and, on a standby, replication lag is under "
             "--healthz-max-lag-seconds; 503 otherwise) and GET /livez "
             "(liveness: 200 whenever serving, lag-blind); 0 disables",
    )
    parser.add_argument(
        "--healthz-max-lag-seconds", type=float, default=30.0,
        help="replication lag above which a standby's /healthz turns 503",
    )
    add_common_flags(parser)
    add_observability_flags(parser)
    args = parser.parse_args(argv)
    setup_logging(args)
    obs = start_observability(args, "oim-registry")
    if args.role == "standby" and not args.peer:
        raise SystemExit("--role standby requires --peer")
    if args.quorum and args.peer:
        raise SystemExit("--quorum and --peer are mutually exclusive "
                         "(pair mode vs raft mode)")
    if args.quorum:
        from oim_tpu_torch.common.endpoints import parse_endpoint_list

        members = parse_endpoint_list(args.quorum)
        if len(members) < 3:
            raise SystemExit(
                f"--quorum needs 3+ members (a 2-node deployment is the "
                f"--peer pair), got {len(members)}")
        if not args.advertise:
            raise SystemExit("--quorum requires --advertise (this "
                             "node's entry in the member list)")
        if args.advertise not in members:
            raise SystemExit(
                f"--advertise {args.advertise!r} is not in the "
                f"--quorum member list {members}")
    db = FileRegistryDB(args.db_file) if args.db_file else MemRegistryDB()
    service = RegistryService(
        db=db, tls=load_tls_flags(args),
        boot_grace_seconds=args.boot_grace_seconds if args.db_file else 0.0,
    )
    manager = None
    if args.quorum:
        from oim_tpu_torch.registry.quorum import QuorumManager

        manager = QuorumManager(
            service,
            node_id=args.advertise,
            peers=[m for m in members if m != args.advertise],
            election_timeout_s=args.election_timeout_seconds,
            state_file=f"{args.db_file}.quorum" if args.db_file else "",
        )
    elif args.peer:
        manager = ReplicationManager(
            service,
            peer=args.peer,
            role=args.role.upper(),
            primary_lease_seconds=args.primary_lease_seconds,
            boot_grace_seconds=args.boot_grace_seconds,
            state_file=f"{args.db_file}.repl" if args.db_file else "",
        )
    server = registry_server(args.endpoint, service)
    healthz = None
    stop_telemetry = None
    if obs.server is not None and args.telemetry_id != "none":
        stop_telemetry = _local_telemetry_row(
            service, manager, args.telemetry_id or "registry",
            f"{obs.server.host}:{obs.server.port}")
    try:
        if manager is not None:
            # After the gRPC server is up so the peer's boot probe can
            # reach us while our own probe runs.
            manager.start()
        if args.healthz_port:
            healthz = HealthzServer(
                manager, port=args.healthz_port,
                max_lag_seconds=args.healthz_max_lag_seconds,
            ).start()
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        # A startup failure (e.g. healthz port already bound) must not
        # leave the non-daemon gRPC threads serving a half-built process:
        # stop the server on EVERY exit path so the traceback actually
        # terminates the daemon.
        server.stop()
        if stop_telemetry is not None:
            stop_telemetry()
        if healthz is not None:
            healthz.stop()
        if manager is not None:
            manager.stop()
        close = getattr(db, "close", None)
        if close is not None:
            close()
        obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
