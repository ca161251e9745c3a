"""oim-monitor: the fleet SLO plane's evaluation daemon.

Rides ONE registry Watch stream on the ``telemetry/`` prefix (GetValues
poll fallback against a pre-Watch registry), folds every daemon's
heartbeat-published histogram snapshots into fleet histograms
(counter-reset safe), evaluates the declared SLOs with Google-SRE
multi-window burn rates, and publishes firing alerts as TTL-leased
``alert/<name>`` registry rows — the rows ``oimctl --alerts`` lists,
``--top`` banners, and a future autoscaler consumes. The monitor's own
/metrics carries ``oim_slo_burn_rate{slo}`` and
``oim_slo_alerts_firing``; episodes land in the flight recorder as
``slo_alert_fired`` / ``slo_alert_resolved``.

    oim-monitor --registry localhost:9421 \
        --slo-first-token-p99-ms 250 --slo-availability 0.999
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
from oim_tpu_torch.obs.monitor import FleetMonitor
from oim_tpu_torch.obs.slo import DEFAULT_BURN_THRESHOLD, SLO, SloEngine


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("oim-monitor")
    add_registry_flag(parser, required=True,
                      help_suffix="source of the telemetry/<id> rows and "
                                  "sink of the alert/<name> rows")
    parser.add_argument(
        "--interval", type=float, default=5.0,
        help="seconds between SLO evaluation ticks (alert rows are "
             "re-published with a lease on each tick while firing)",
    )
    parser.add_argument(
        "--slo-first-token-p99-ms", type=float, default=250.0,
        help="first-token latency SLO: 99%% of requests must see their "
             "first token within this many milliseconds (snapped down "
             "to a histogram bucket bound); <= 0 disables the SLO",
    )
    parser.add_argument(
        "--slo-availability", type=float, default=0.999,
        help="availability objective over oim_serve_requests_total "
             "outcomes (rejected/error are the bad set); "
             ">= 1 disables the SLO",
    )
    parser.add_argument(
        "--fast-window", type=float, default=300.0,
        help="fast burn-rate window seconds (proves the problem is "
             "happening NOW; the SRE-workbook 5m default)",
    )
    parser.add_argument(
        "--slow-window", type=float, default=3600.0,
        help="slow burn-rate window seconds (proves it is sustained; "
             "the 1h default) — alerts require BOTH windows to breach",
    )
    parser.add_argument(
        "--burn-threshold", type=float, default=DEFAULT_BURN_THRESHOLD,
        help="error-budget burn multiple that fires an alert (14.4 = "
             "a 30-day budget gone in ~2 days)",
    )
    parser.add_argument(
        "--resolve-hold", type=float, default=120.0,
        help="seconds the burn must stay under the threshold before a "
             "firing alert resolves (flap hysteresis: one fired/resolved "
             "event pair per episode)",
    )
    parser.add_argument(
        "--no-watch", action="store_true",
        help="disable the registry Watch stream and poll GetValues "
             "every tick (the pre-Watch behavior; normally the poll is "
             "only the mixed-version fallback)",
    )
    add_common_flags(parser)
    add_observability_flags(parser)
    args = parser.parse_args(argv)
    setup_logging(args)
    log = from_context()
    obs = start_observability(args, "oim-monitor")
    tls = load_tls_flags(args, peer_name="component.registry")

    slos = []
    if args.slo_first_token_p99_ms > 0:
        slos.append(SLO(
            name="first_token_p99", kind="latency", objective=0.99,
            metric="first_token",
            threshold_s=args.slo_first_token_p99_ms / 1e3))
    if 0 < args.slo_availability < 1:
        slos.append(SLO(name="availability", kind="availability",
                        objective=args.slo_availability))
    if not slos:
        raise SystemExit("every SLO disabled: nothing to monitor")
    engine = SloEngine(
        slos,
        fast_window_s=args.fast_window,
        slow_window_s=args.slow_window,
        burn_threshold=args.burn_threshold,
        resolve_hold_s=args.resolve_hold,
    )
    monitor = FleetMonitor(
        args.registry, engine, interval=args.interval,
        monitor_id=args.telemetry_id or "monitor", tls=tls,
        watch=not args.no_watch)
    monitor.start()
    # "monitor" works insecure; under mTLS the registry's alert-row rule
    # requires the component.monitor identity (dot-suffix for HA pairs).
    start_telemetry_row(obs, args.telemetry_id or "monitor", "monitor",
                        args.registry, tls=tls, interval=args.interval)
    log.info("oim-monitor evaluating", registry=args.registry,
             slos=[s.name for s in slos],
             windows_s=(args.fast_window, args.slow_window),
             burn_threshold=args.burn_threshold)

    stopping = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    try:
        while not stopping.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    log.info("stopping", firing=engine.firing())
    # Keep firing alert rows on the registry (their lease bounds them):
    # a draining monitor must not mask a live incident by deleting its
    # alerts on the way out.
    monitor.stop(deregister=False)
    obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
