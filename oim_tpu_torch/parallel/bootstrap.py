"""Multi-host bootstrap (``oim_tpu/parallel/bootstrap.py``): the registry
names the ranks and the rendezvous of ``torch.distributed``.

Every host's controller registers ``<id>/address`` and ``<id>/mesh``. Each
trainer polls the registry until ``expected_hosts`` controllers are
there, sorts the hosts by mesh coordinate (ties by id), a total order
every host derives alone from the same rows, and joins the process group
with rank 0's host as the rendezvous. No election is needed: the order is
a function of the registry's contents, and re-registration heals them
after a registry restart.

The layout and the join (``derive_process_layout``,
``join_process_group``) need no grpc; ``wait_for_hosts`` and
``initialize_from_registry`` import it inside, so the card's path can
load this module without grpcio and protobuf.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.common.pathutil import REGISTRY_ADDRESS
from oim_tpu_torch.parallel.mesh import backend_for, topology_from_registry


class BootstrapError(RuntimeError):
    pass


def derive_process_layout(
    entries: dict[str, str], controller_id: str, coordinator_port: int = 8476
) -> tuple[str, int, int]:
    """(coordinator address, number of processes, this process's rank)
    from registry entries, the same on every host.

    Hosts sort by (x, y, z, core), an unset component last, then by id.
    The coordinator is rank 0's registered address with its port replaced
    by ``coordinator_port`` (the registered port is the controller's)."""
    topo = topology_from_registry(entries)
    addresses = {}
    for path, value in entries.items():
        parts = path.split("/")
        if len(parts) == 2 and parts[1] == REGISTRY_ADDRESS:
            addresses[parts[0]] = value
    hosts = sorted(
        addresses,
        key=lambda h: (
            tuple(c if c >= 0 else 1 << 30 for c in _coord_key(topo.get(h, MeshCoord()))),
            h,
        ),
    )
    if controller_id not in hosts:
        raise BootstrapError(
            f"controller {controller_id!r} not registered (have: {sorted(hosts)})")
    host_part = addresses[hosts[0]].rsplit(":", 1)[0]
    return f"{host_part}:{coordinator_port}", len(hosts), hosts.index(controller_id)


def _coord_key(c: MeshCoord):
    return (c.x, c.y, c.z, c.core)


def wait_for_hosts(registry_stub, expected_hosts: int, timeout: float = 300.0,
                   poll: float = 1.0, redial=None) -> dict[str, str]:
    """Poll GetValues("") until ``expected_hosts`` controllers registered.

    The registry's default read is lease-filtered, so only controllers
    with live leases count: a host that registered and died before the
    ranks assembled cannot wedge the join with a stale address. A
    registry that is restarting (``FAILOVER_CODES``) is retried until the
    deadline; ``redial()``, given, rotates to the next registry endpoint
    and returns a fresh stub."""
    import grpc

    from oim_tpu_torch.common.endpoints import FAILOVER_CODES
    from oim_tpu_torch.spec import oim_pb2 as pb

    deadline = time.monotonic() + timeout
    n, last_err = 0, None
    while True:
        try:
            reply = registry_stub.GetValues(pb.GetValuesRequest(path=""), timeout=10.0)
        except grpc.RpcError as err:
            if err.code() not in FAILOVER_CODES:
                raise
            last_err = err
            if redial is not None:
                registry_stub = redial()
        else:
            last_err = None
            entries = {v.path: v.value for v in reply.values}
            n = sum(1 for p in entries if p.endswith(f"/{REGISTRY_ADDRESS}"))
            if n >= expected_hosts:
                return entries
        if time.monotonic() > deadline:
            if last_err is not None:
                raise BootstrapError(
                    f"registry unavailable through bootstrap timeout: "
                    f"{last_err.details()}") from last_err
            raise BootstrapError(f"only {n}/{expected_hosts} hosts registered before timeout")
        time.sleep(poll)


def join_process_group(coordinator: str, n: int, pid: int, device="cuda",
                       local_ranks: int = 1) -> None:
    """Join the ``n``-rank process group as rank ``pid`` with its
    rendezvous at ``coordinator`` (host:port; rank 0 listens there).
    ``local_ranks`` is the number of ranks on this host: NCCL when each
    has its own card, gloo on the CPU and for ranks that share one. A
    group already joined with the same size and rank is kept."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, pid):
            raise BootstrapError(
                f"a process group of {dist.get_world_size()} ranks (this one "
                f"{dist.get_rank()}) is already joined; the registry gives {n} "
                f"ranks and this process rank {pid}")
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, local_ranks), init_method=f"tcp://{coordinator}",
                            world_size=n, rank=pid)


def initialize_from_registry(
    registry_address: str,
    controller_id: str,
    expected_hosts: int,
    tls=None,
    coordinator_port: int = 8476,
    timeout: float = 300.0,
    device="cuda",
    local_rank: int = 0,
    local_ranks: int = 1,
) -> tuple[int, int]:
    """Wait for the hosts to assemble in the registry, then join the
    process group (``join_process_group`` on ``device``). Returns (rank,
    number of processes).

    The registry ranks hosts; ``local_ranks`` processes a host (torchrun's
    ``LOCAL_WORLD_SIZE``, one a card) make the group ``n * local_ranks``
    ranks, this one ``host rank * local_ranks + local_rank``. With one
    process a host, as JAX's, it is (host rank, n), and a registry of one
    host joins no group and is (0, 1). ``registry_address`` may list
    endpoints (primary,standby): assembly fails over to the next when the
    current one is down."""
    from oim_tpu_torch.common.endpoints import RegistryEndpoints
    from oim_tpu_torch.common.tlsutil import dial
    from oim_tpu_torch.spec.services import RegistryStub

    if not 0 <= local_rank < local_ranks:
        raise BootstrapError(f"local rank {local_rank} is not one of {local_ranks} on the host")
    endpoints = RegistryEndpoints(registry_address)
    state: dict = {"channel": None}

    def connect() -> RegistryStub:
        if state["channel"] is not None:
            state["channel"].close()
        state["channel"] = dial(endpoints.current(), tls, "component.registry")
        return RegistryStub(state["channel"])

    def redial() -> RegistryStub:
        endpoints.advance()
        return connect()

    try:
        entries = wait_for_hosts(connect(), expected_hosts, timeout, redial=redial)
    finally:
        if state["channel"] is not None:
            state["channel"].close()
    coordinator, n, pid = derive_process_layout(entries, controller_id, coordinator_port)
    world, rank = n * local_ranks, pid * local_ranks + local_rank
    if world > 1:
        join_process_group(coordinator, world, rank, device, local_ranks)
    return rank, world
