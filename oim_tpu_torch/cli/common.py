"""Flags shared by the port's CLIs (``oim_tpu/cli/common.py``):
``--registry``, the logging and mTLS flags, and the observability flags.

``--metrics-port`` serves ``/metrics``, ``/debug/spans`` and
``/debug/events``; ``--trace-dir`` streams finished spans to
``<service>-<pid>.trace.json`` and receives the flight recorder's dump on
SIGQUIT, an unhandled crash and ``Observability.stop()``.
``start_telemetry_row`` publishes the daemon's ``telemetry/<id>`` registry
row (``--telemetry-id``) when a metrics server and a registry are both
set. ``load_tls_flags`` and ``start_telemetry_row`` import the gRPC
modules only when they are used, so this module loads on a machine
without grpcio.
"""

from __future__ import annotations

import argparse
import os

from oim_tpu_torch.common import logging as oim_logging


def add_registry_flag(
    parser: argparse.ArgumentParser,
    default: str = "",
    required: bool = False,
    help_suffix: str = "",
) -> None:
    """The shared ``--registry`` flag: one endpoint, or a comma-separated
    list (``primary:9421,standby:9421``) with a replicated registry;
    clients fail over to the next endpoint on UNAVAILABLE /
    FAILED_PRECONDITION (common/endpoints.py)."""
    parser.add_argument(
        "--registry",
        default=default,
        required=required,
        help="registry endpoint, or comma-separated list primary,standby "
             "(clients fail over on UNAVAILABLE/FAILED_PRECONDITION)"
             + (f"; {help_suffix}" if help_suffix else ""),
    )


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    """--log-level (default $OIM_LOG_LEVEL or info), --log-format, and the
    mTLS material --ca / --key."""
    parser.add_argument(
        "--log-level",
        default=os.environ.get("OIM_LOG_LEVEL", "info"),
        help="debug|info|warning|error (OIM_LOG_LEVEL env overrides the default)",
    )
    parser.add_argument(
        "--log-format",
        default="text",
        choices=oim_logging.FORMATS,
        help="text = '<time> <level> <msg> | k: v'; json = one JSON object "
             "per line with fields flattened (log aggregators)",
    )
    parser.add_argument("--ca", default="", help="CA certificate file (mTLS)")
    parser.add_argument(
        "--key",
        default="",
        help="path prefix for <prefix>.key/.crt (reference .key/.crt convention)",
    )


def setup_logging(args: argparse.Namespace) -> None:
    oim_logging.set_global(
        oim_logging.Logger(
            level=oim_logging.parse_level(args.log_level),
            fmt=getattr(args, "log_format", "text"),
        )
    )


def load_tls_flags(args: argparse.Namespace, peer_name: str = ""):
    """The TLSConfig of --ca/--key, or None when neither is given."""
    if not args.ca and not args.key:
        return None
    if not (args.ca and args.key):
        raise SystemExit("--ca and --key must be given together")
    from oim_tpu_torch.common.tlsutil import load_tls

    return load_tls(args.ca, args.key, peer_name)


def add_observability_flags(parser: argparse.ArgumentParser) -> None:
    """--metrics-port / --metrics-host / --trace-dir / the trace-ring and
    tail-sampling knobs / --events-ring."""
    parser.add_argument(
        "--metrics-port", type=int, default=-1,
        help=">=0 serves GET /metrics (Prometheus text + OpenMetrics "
             "exemplars), GET /debug/spans (span ring buffer, Chrome "
             "trace JSON) and GET /debug/events (flight recorder); "
             "0 = ephemeral port",
    )
    parser.add_argument(
        "--metrics-host", default="127.0.0.1",
        help="bind address for the metrics server; 0.0.0.0 lets Prometheus "
             "scrape from another pod (default loopback)",
    )
    parser.add_argument(
        "--trace-dir", default="",
        help="stream finished spans into <dir>/<service>-<pid>.trace.json "
             "(Chrome trace-event JSON: open in Perfetto / chrome://tracing; "
             "merge processes with tracing.merge_trace_dir); the flight "
             "recorder dumps <service>-<pid>.events.json here on SIGQUIT, "
             "crash, and shutdown",
    )
    parser.add_argument(
        "--trace-ring", type=int, default=4096,
        help="span ring-buffer capacity behind /debug/spans: a busy serve "
             "replica evicts router/feeder hops from a small ring before "
             "an operator can read it — raise this on hot daemons",
    )
    parser.add_argument(
        "--trace-sample", type=float, default=1.0,
        help="tail-sampling keep probability for the --trace-dir stream: "
             "error spans and spans slower than --trace-slow-ms ALWAYS "
             "export; the rest export with this probability, decided per "
             "trace_id so a kept trace keeps every hop (1.0 = keep all)",
    )
    parser.add_argument(
        "--trace-slow-ms", type=float, default=100.0,
        help="latency threshold above which a span always exports to "
             "--trace-dir regardless of --trace-sample (the tail worth "
             "keeping); 0 disables the slow-keep rule",
    )
    parser.add_argument(
        "--events-ring", type=int, default=2048,
        help="flight-recorder ring capacity behind /debug/events "
             "(typed control-plane events stamped with trace ids); "
             "0 disables event recording",
    )
    parser.add_argument(
        "--telemetry-id", default="",
        help="id for this daemon's TTL-leased telemetry/<id> registry "
             "row (metrics endpoint + role; the `oimctl --top` "
             "discovery row). Default: derived from the daemon's own "
             "identity; 'none' disables. Published only when both a "
             "metrics server and a registry are configured; under mTLS "
             "the id must match the dialing identity's own id (or be a "
             "dot-suffixed variant)",
    )


class Observability:
    """Started telemetry for one process: span recorder + flight recorder
    + metrics server (+ the telemetry registry row, when started)."""

    def __init__(self, server, recorder, service: str = "",
                 trace_dir: str = ""):
        self.server = server  # MetricsServer | None
        self.recorder = recorder
        self.service = service
        self.trace_dir = trace_dir
        self.telemetry = None  # TelemetryRegistration | None

    def dump_events(self) -> str | None:
        """Flight-recorder post-mortem dump into --trace-dir (SIGQUIT /
        crash / shutdown). Best-effort: a full disk must not mask the
        original failure."""
        if not self.trace_dir:
            return None
        from oim_tpu_torch.common import events

        try:
            return events.dump_to(self.trace_dir, self.service or "oim")
        except OSError:
            return None

    def stop(self) -> None:
        if self.telemetry is not None:
            self.telemetry.stop(deregister=True)
            self.telemetry = None
        self.dump_events()
        self.recorder.flush()
        self.recorder.close()
        if self.server is not None:
            self.server.stop()


def start_observability(args: argparse.Namespace, service: str) -> Observability:
    """Configure the process-global span + event recorders (service names
    the Perfetto process and the dump files) and start the metrics server
    when requested. With a --trace-dir, SIGQUIT and an unhandled crash
    dump the flight recorder next to the span stream."""
    import signal
    import sys

    from oim_tpu_torch.common import events, tracing
    from oim_tpu_torch.common.logging import from_context

    trace_dir = getattr(args, "trace_dir", "")
    recorder = tracing.configure(
        service, trace_dir=trace_dir,
        capacity=getattr(args, "trace_ring", 4096),
        sample=getattr(args, "trace_sample", 1.0),
        slow_threshold_s=getattr(args, "trace_slow_ms", 100.0) / 1000.0)
    events.configure(capacity=getattr(args, "events_ring", 2048))
    server = None
    if getattr(args, "metrics_port", -1) >= 0:
        from oim_tpu_torch.common.metrics import MetricsServer

        server = MetricsServer(
            port=args.metrics_port, host=args.metrics_host).start()
        from_context().info(
            "metrics", host=server.host, port=server.port)
    obs = Observability(server, recorder, service, trace_dir)
    if trace_dir:
        def _dump_on_signal(signum, frame):  # noqa: ARG001 - signal API
            path = obs.dump_events()
            recorder.flush()
            from_context().info("flight recorder dumped", path=path,
                                signal=signum)

        try:
            signal.signal(signal.SIGQUIT, _dump_on_signal)
        except (ValueError, AttributeError):
            pass  # non-main thread (tests) or no SIGQUIT (non-POSIX)

        prev_hook = sys.excepthook

        def _dump_on_crash(exc_type, exc, tb):
            obs.dump_events()
            recorder.flush()
            prev_hook(exc_type, exc, tb)

        sys.excepthook = _dump_on_crash
    return obs


def start_telemetry_row(
    obs: Observability,
    telemetry_id: str,
    role: str,
    registry_address: str,
    tls=None,
    interval: float = 10.0,
):
    """Self-publish this daemon's TTL-leased ``telemetry/<id>`` registry
    row (metrics endpoint + role) so ``oimctl --top`` discovers it. A
    no-op without a metrics server or registry, or with the id "none".
    Stops with ``obs.stop()``."""
    if (obs.server is None or not registry_address or not telemetry_id
            or telemetry_id == "none"):
        return None
    from oim_tpu_torch.common.logging import from_context
    from oim_tpu_torch.common.telemetry import TelemetryRegistration

    registration = TelemetryRegistration(
        telemetry_id, role,
        f"{obs.server.host}:{obs.server.port}",
        registry_address, interval=interval, tls=tls)
    registration.start()
    obs.telemetry = registration
    from_context().info("telemetry row published", row=registration.key,
                        role=role, metrics=registration.metrics_endpoint)
    return registration
