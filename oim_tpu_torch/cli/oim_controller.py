"""oim-controller for the port (``oim_tpu/cli/oim_controller.py``): a
controller daemon that stages volumes onto this host's CUDA cards, serves
the Controller and Identity services, and registers with a registry.

    python -m oim_tpu.cli.oim_registry --endpoint tcp://127.0.0.1:9421 &
    python -m oim_tpu_torch.cli.oim_controller --controller-id host-0 \\
        --endpoint tcp://127.0.0.1:9422 --controller-address 127.0.0.1:9422 \\
        --registry 127.0.0.1:9421 --registry-delay 5

``--backend cuda`` (the default) stages onto ``--device`` (``cuda``: every
card, round robin); ``--backend malloc`` holds volumes in host memory.
``--device-mesh data=4,model=2`` places specs that name mesh axes over a
``plane.LocalMesh`` of this host's cards (the devices named by
``--device``, in index order; ``--device cpu`` stands as many CPU
devices as the axes need in for them). With ``--metrics-port`` and a
registry the daemon publishes its ``telemetry/<id>`` row
(``--telemetry-id``, default the controller id), renewed by the
controller's own heartbeat as a batched key.
"""

from __future__ import annotations

import argparse
import math

import torch

from oim_tpu_torch.cli.common import (
    add_common_flags,
    add_observability_flags,
    add_registry_flag,
    load_tls_flags,
    setup_logging,
    start_observability,
    start_telemetry_row,
)
from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.controller import CUDABackend, MallocBackend
from oim_tpu_torch.controller.controller import Controller, controller_server
from oim_tpu_torch.data import plane
from oim_tpu_torch.parallel.mesh import parse_axes


def device_mesh(spec: str, device: str) -> plane.LocalMesh | None:
    """--device-mesh over the cards ``device`` names (every card for a
    bare "cuda"), or over as many CPU devices as the axes need for "cpu";
    None when unset."""
    try:
        axes = parse_axes(spec)
    except ValueError as e:
        raise SystemExit(f"--device-mesh: {e}") from e
    if not axes:
        return None
    need = math.prod(s for _, s in axes)
    dev = torch.device(device)
    if dev.type == "cpu":
        devices = ["cpu"] * need
    elif dev.index is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    try:
        return plane.LocalMesh(axes, devices)
    except ValueError as e:
        raise SystemExit(f"--device-mesh: {e}") from e


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("oim-controller (torch)")
    parser.add_argument("--endpoint", default="tcp://0.0.0.0:8998")
    parser.add_argument("--controller-id", required=True)
    parser.add_argument(
        "--controller-address", default="",
        help="address registered into the registry")
    add_registry_flag(parser, help_suffix="address(es) to register at")
    parser.add_argument(
        "--registry-delay", type=float, default=60.0,
        help="heartbeat/re-registration interval seconds")
    parser.add_argument(
        "--lease-seconds", type=float, default=0.0,
        help="registry lease TTL; 0 derives 2.5x --registry-delay, "
             "negative registers permanent (pre-lease) entries")
    parser.add_argument(
        "--backend", choices=("cuda", "malloc"), default="cuda",
        help="staging backend (malloc = host memory only)")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the cuda backend stages onto (cuda = every card, "
             "round robin; cpu stages into host tensors through the same pipeline)")
    parser.add_argument(
        "--mesh-coord", default="", help="this host's coordinate x,y,z[,core]")
    parser.add_argument(
        "--device-mesh", default="",
        help="mesh of this host's cards for sharded placements, e.g. data=4,model=2 "
             "(without it, MapVolume requests with sharding_axes are rejected)")
    parser.add_argument(
        "--chunk-bytes", type=int, default=64 << 20,
        help="staging pipeline chunk size (cuda backend)")
    parser.add_argument(
        "--stage-workers", type=int, default=0,
        help="concurrent shard-group staging pool width (0 = the default)")
    parser.add_argument(
        "--cache-bytes", type=int, default=-1,
        help="content-addressed stage cache capacity (-1 = default "
             "$OIM_STAGE_CACHE_BYTES or 1 GiB; 0 disables caching)")
    parser.add_argument(
        "--no-keep-cached", action="store_true",
        help="free cached staged arrays on last unmap instead of keeping "
             "them resident for O(1) re-mount")
    add_common_flags(parser)
    add_observability_flags(parser)
    return parser.parse_args(argv)


def build(args: argparse.Namespace):
    """(Controller, its started server) from parsed flags."""
    tls = load_tls_flags(args)
    cache_bytes = None if args.cache_bytes < 0 else args.cache_bytes
    if args.backend == "cuda":
        backend = CUDABackend(
            device=args.device, mesh=device_mesh(args.device_mesh, args.device),
            chunk_bytes=args.chunk_bytes, stage_workers=args.stage_workers or None,
            cache_bytes=cache_bytes, keep_cached=not args.no_keep_cached)
    else:
        backend = MallocBackend(cache_bytes=cache_bytes,
                                keep_cached=not args.no_keep_cached)
    coord = MeshCoord.parse(args.mesh_coord) if args.mesh_coord else None
    # The telemetry/<id> row rides the controller heartbeat as a batched
    # key, as the JAX daemon's does.
    telemetry_id = args.telemetry_id or args.controller_id
    controller = Controller(
        controller_id=args.controller_id, backend=backend,
        controller_address=args.controller_address, registry_address=args.registry,
        registry_delay=args.registry_delay, lease_seconds=args.lease_seconds,
        mesh_coord=coord, tls=tls,
        extra_lease_keys=[f"telemetry/{telemetry_id}"] if telemetry_id != "none" else [])
    server = controller_server(args.endpoint, controller.service, tls=tls)
    controller.start()
    return controller, server


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    setup_logging(args)
    obs = start_observability(args, "oim-controller")
    controller, server = build(args)
    start_telemetry_row(obs, args.telemetry_id or args.controller_id, "controller",
                        args.registry, tls=load_tls_flags(args))
    try:
        server.wait()
    except KeyboardInterrupt:
        controller.stop()
        server.stop()
    finally:
        obs.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
