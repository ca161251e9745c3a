"""oim-autoscaler: the fleet actuator daemon.

Rides ONE registry Watch stream on the root prefix (GetValues poll
fallback against a pre-Watch registry): ``alert/`` rows are the scale
signal, ``serve/`` rows the observed fleet, ``fleet/autoscaler`` the
TTL-leased desired-state row whose lease doubles as leader election —
run two autoscalers and the standby defers while the leader's monotonic
beat progresses, claiming the key once it freezes or the lease lapses.
Actuation forks/drains real ``oim-serve`` processes through the
SubprocessLauncher: every flag after ``--`` is passed through to each
spawned replica (weights source, controller id, TLS, sizing), with
``--serve-id`` and ``--weights-version`` appended per spawn.

    oim-autoscaler --registry localhost:9421 --min 1 --max 4 \
        -- --restore-only --weights-volume weights \
           --registry localhost:9421 --controller-id host-0 \
           --endpoint tcp://0.0.0.0:0 --advertise 10.0.0.7:9002 \
           --device cpu

A rolling weight upgrade is a restart with ``--weights-version v2``
(plus a ``--prestage-cmd`` that publishes + fans out the v2 volume):
the reconciler surges one v2 spawn, drains one stale replica per
cooldown, and the router pins in-flight (and retried) streams to their
version while both serve.
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("oim-autoscaler")
    add_registry_flag(parser, required=True,
                      help_suffix="source of the alert/ and serve/ rows, "
                                  "sink of the fleet/ desired-state row")
    parser.add_argument("--min", type=int, default=1,
                        help="replica floor (0 = scale to zero)")
    parser.add_argument("--max", type=int, default=1,
                        help="replica ceiling an alert can scale up to")
    parser.add_argument(
        "--weights-version", default="",
        help="desired weights version: spawns advertise it and replicas "
             "advertising anything else are flipped one drain at a time "
             "(rolling upgrade). Empty = unversioned")
    parser.add_argument(
        "--interval", type=float, default=5.0,
        help="seconds between reconcile ticks; the leader's fleet/ row "
             "is re-published (beat++) each tick with a 2.5x lease")
    parser.add_argument(
        "--cooldown", type=float, default=15.0,
        help="minimum seconds between elastic actions (flap damping); "
             "repair spawns back to the current target are exempt")
    parser.add_argument(
        "--scale-down-hold", type=float, default=60.0,
        help="alert-free seconds before the target decays toward --min")
    parser.add_argument(
        "--autoscaler-id", default="",
        help="identity in the fleet/ row (default: --telemetry-id or "
             "'autoscaler'; give the standby a distinct id, e.g. "
             "autoscaler.b — under mTLS both need component.autoscaler "
             "certs, dot-suffixed for the standby)")
    parser.add_argument(
        "--serve-id-prefix", default="auto",
        help="spawned replicas register as <prefix>-<n>")
    parser.add_argument(
        "--prestage-cmd", default="",
        help="shell-split command run once per new weights version "
             "before its first spawn ('{version}' substituted): publish "
             "+ PrestageVolume fan-out of the new volume, so every boot "
             "is an O(1) stage-cache hit")
    parser.add_argument(
        "--no-watch", action="store_true",
        help="disable the registry Watch stream and poll GetValues "
             "every tick (the pre-Watch behavior; normally the poll is "
             "only the mixed-version fallback)")
    parser.add_argument(
        "serve_args", nargs=argparse.REMAINDER,
        help="flags after -- are passed through to every spawned "
             "oim-serve (weights source, controller id, TLS, sizing)")
    add_common_flags(parser)
    add_observability_flags(parser)
    args = parser.parse_args(argv)
    setup_logging(args)
    log = from_context()
    if args.min < 0 or args.max < args.min:
        raise SystemExit(f"need 0 <= --min <= --max, "
                         f"got min={args.min} max={args.max}")
    obs = start_observability(args, "oim-autoscaler")
    tls = load_tls_flags(args, peer_name="component.registry")

    import shlex

    from oim_tpu_torch.autoscale import (
        Autoscaler,
        FleetSpec,
        SubprocessLauncher,
    )

    serve_args = list(args.serve_args)
    if serve_args and serve_args[0] == "--":
        serve_args = serve_args[1:]
    launcher = SubprocessLauncher(
        serve_args,
        serve_id_prefix=args.serve_id_prefix,
        prestage_argv=shlex.split(args.prestage_cmd),
    )
    spec = FleetSpec(
        min_replicas=args.min, max_replicas=args.max,
        version=args.weights_version,
        cooldown_s=args.cooldown,
        scale_down_hold_s=args.scale_down_hold,
    )
    autoscaler_id = args.autoscaler_id or args.telemetry_id or "autoscaler"
    autoscaler = Autoscaler(
        args.registry, spec, launcher,
        autoscaler_id=autoscaler_id, interval=args.interval,
        tls=tls, watch=not args.no_watch)
    autoscaler.start()
    # "autoscaler" works insecure; under mTLS the registry's fleet-row
    # rule requires the component.autoscaler identity (dot-suffix for
    # the HA standby).
    start_telemetry_row(obs, args.telemetry_id or "autoscaler",
                        "autoscaler", args.registry, tls=tls,
                        interval=args.interval)
    log.info("oim-autoscaler reconciling", registry=args.registry,
             autoscaler=autoscaler_id, min=args.min, max=args.max,
             version=args.weights_version or None)

    stopping = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    try:
        while not stopping.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    log.info("stopping", leader=autoscaler.is_leader)
    # A stopping LEADER deletes its fleet row so the standby promotes on
    # the pushed delete instead of waiting out the lease. The replicas
    # this launcher spawned keep serving: the autoscaler going away must
    # not take the fleet's capacity with it.
    autoscaler.stop(deregister=True)
    obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
