"""oim-feeder for the port (``oim_tpu/cli/oim_feeder.py``): the feeder
served as a node daemon (``oim.v1.Feeder`` and ``oim.v1.Identity``).

Two modes, exactly one of them:

- **local**, ``--backend cuda|malloc``: the daemon hosts a controller,
  and volumes live in this process (``cuda``: on ``--device``, and
  ``--device-mesh data=4,model=2`` places specs that name mesh axes over
  this host's cards, as ``oim_controller`` does);
- **remote**, ``--registry`` with ``--controller-id``: the daemon is a
  node-side proxy to a controller elsewhere; data windows stream straight
  from the controller's registered endpoint over a pooled channel, with
  the registry's proxy as the fallback (``--no-direct-data``: always the
  proxy).

    python -m oim_tpu_torch.cli.oim_feeder --endpoint tcp://127.0.0.1:9001 \\
        --backend malloc
    python -m oim_tpu_torch.cli.oim_feeder --endpoint tcp://127.0.0.1:9001 \\
        --registry 127.0.0.1:9421 --controller-id host-0

With ``--metrics-port`` and a registry the daemon publishes its
``telemetry/<id>`` row (``--telemetry-id``, default
``<controller-id>.feeder``).
"""

from __future__ import annotations

import argparse

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


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("oim-feeder (torch)")
    parser.add_argument("--endpoint", default="tcp://0.0.0.0:9001",
                        help="listen endpoint (tcp:// or unix://)")
    parser.add_argument("--backend", default="", choices=("", "malloc", "cuda"),
                        help="local mode: serve an in-process controller with this backend")
    parser.add_argument("--device", default="cuda",
                        help="local cuda mode: the torch device volumes stage onto "
                             "(cuda = every card, round robin)")
    parser.add_argument("--device-mesh", default="",
                        help="local cuda mode: mesh of this host's cards for sharded "
                             "placements, e.g. data=4,model=2")
    add_registry_flag(parser, help_suffix="remote mode")
    parser.add_argument("--controller-id", default="", help="remote mode: target controller")
    parser.add_argument(
        "--warm-standby", action="store_true",
        help="remote mode: after each publish, prestage the live replica controller at "
             "the same mesh coordinate (PrestageVolume)")
    parser.add_argument(
        "--no-direct-data", dest="direct_data", action="store_false",
        help="remote mode: stream every data window through the registry's proxy "
             "instead of dialing the owning controller directly")
    parser.add_argument(
        "--window-chunk-bytes", type=int, default=0,
        help="preferred ReadVolume chunk size asked of the controller (0 = the "
             "feeder's default, 16 MiB; the server clamps)")
    parser.add_argument("--publish-timeout", type=float, default=60.0)
    add_common_flags(parser)
    add_observability_flags(parser)
    args = parser.parse_args(argv)
    if args.window_chunk_bytes < 0:
        parser.error(f"--window-chunk-bytes must be positive (0 = default), "
                     f"got {args.window_chunk_bytes}")
    local = bool(args.backend)
    if local == bool(args.registry or args.controller_id):
        raise SystemExit("exactly one of --backend (local) or "
                         "--registry + --controller-id (remote) required")
    if local and args.warm_standby:
        # The replica to prestage is found in the registry, which a local
        # daemon has none of.
        raise SystemExit("--warm-standby requires remote mode "
                         "(--registry + --controller-id)")
    return args


def build_feeder(args: argparse.Namespace):
    """The Feeder the daemon serves: over an in-process controller
    (local mode) or a remote one."""
    from oim_tpu_torch.feeder import Feeder

    if args.backend:
        from oim_tpu_torch.controller import CUDABackend, MallocBackend
        from oim_tpu_torch.controller.controller import ControllerService

        if args.backend == "cuda":
            from oim_tpu_torch.cli.oim_controller import device_mesh

            backend = CUDABackend(device=args.device,
                                  mesh=device_mesh(args.device_mesh, args.device))
        else:
            backend = MallocBackend()
        return Feeder(controller=ControllerService(backend))
    return Feeder(registry_address=args.registry, controller_id=args.controller_id,
                  tls=load_tls_flags(args), warm_standby=args.warm_standby,
                  direct_data=args.direct_data, window_chunk_bytes=args.window_chunk_bytes)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    setup_logging(args)
    from oim_tpu_torch.feeder import FeederDaemon, feeder_server

    obs = start_observability(args, "oim-feeder")
    try:
        feeder = build_feeder(args)
        daemon = FeederDaemon(feeder, default_timeout=args.publish_timeout)
        server = feeder_server(args.endpoint, daemon, tls=load_tls_flags(args))
    except BaseException:
        obs.stop()
        raise
    # Remote mode dials the registry as host.<controller-id>, so the
    # dot-suffixed id is the row name it may write.
    start_telemetry_row(obs, args.telemetry_id or f"{args.controller_id}.feeder", "feeder",
                        args.registry, tls=load_tls_flags(args))
    from_context().info("oim-feeder serving", endpoint=args.endpoint, addr=server.addr,
                        mode="local" if args.backend else "remote")
    try:
        server.wait()
    except KeyboardInterrupt:
        server.stop()
    finally:
        feeder.close()
        obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
