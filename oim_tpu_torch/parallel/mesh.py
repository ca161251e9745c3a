"""Mesh construction (``oim_tpu/parallel/mesh.py``): named axes over the
ranks of a ``torch.distributed`` world.

Axis convention, as in the JAX package (innermost last, fastest varying):
``("data", "fsdp", "seq", "model")``. A rank's place in the mesh is its
row-major index, so with ``data=2,fsdp=2`` ranks 0 and 1 share a data
coordinate and differ in fsdp.

Where the JAX mesh is an array of devices inside one program, the port's
is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks,
one process and one device per rank. Each named axis gets the
DeviceMesh's process group for it; ``Mesh.axis(name)`` hands the group,
this rank's coordinate and the ranks along the axis to the collectives
(``parallel/collectives.py``). A process that never initialised
``torch.distributed`` gets a mesh of size 1 with no groups, and every
collective over it is the identity: the trainer's one-process path.

The registry's ``<id>/mesh`` keys carry TPU torus coordinates; a GPU rank
has none, so ``mesh_from_topology`` orders ranks by rank, as the JAX
package orders devices by id off a TPU.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.common.pathutil import REGISTRY_MESH

MeshAxes = Sequence[tuple[str, int]]


def parse_axes(spec: str) -> list[tuple[str, int]] | None:
    """'data=4,model=2' -> [("data", 4), ("model", 2)]; '' -> None.

    The one mesh-spec grammar of every CLI (--mesh on the trainer)."""
    if not spec:
        return None
    axes = []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"bad mesh component {part!r} (want name=size)")
        axes.append((name.strip(), int(size)))
    return axes


def _check_sizes(axes: MeshAxes, n_devices: int) -> list[tuple[str, int]]:
    axes = [(str(name), int(size)) for name, size in axes]
    total = int(np.prod([s for _, s in axes])) if axes else 1
    if total > n_devices:
        raise ValueError(
            f"mesh axes {axes} require {total} devices, have {n_devices}"
        )
    return axes


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named mesh axis as this rank sees it: its size, this rank's
    coordinate on it, the global ranks along it (in axis order, which is
    the group's rank order) and its process group with that group's
    backend (None for a mesh without ``torch.distributed``)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: Any = None
    backend: str | None = None


class Mesh:
    """Named axes over ranks; ``shape`` maps each axis name to its size in
    order, as ``jax.sharding.Mesh.shape`` does. Without a DeviceMesh, the
    mesh is seen from ``rank`` (default its first rank) and has no
    process groups: a shape to cut pieces by."""

    def __init__(self, axes: MeshAxes, ranks: Sequence[int], device,
                 device_mesh=None, rank: int | None = None):
        self.axis_names = tuple(n for n, _ in axes)
        self.shape = {n: s for n, s in axes}
        self.size = int(np.prod([s for _, s in axes])) if axes else 1
        self.ranks = tuple(ranks)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        grid = np.asarray(self.ranks, dtype=np.int64).reshape(
            tuple(s for _, s in axes))
        if rank is None:
            rank = dist.get_rank() if device_mesh is not None else self.ranks[0]
        where = np.argwhere(grid == rank)
        # None for a rank outside a mesh over a subset of the world.
        self.coordinate = tuple(int(c) for c in where[0]) if len(where) else None
        self._axes: dict[str, Axis] = {}
        if self.coordinate is None:
            return
        for dim, name in enumerate(self.axis_names):
            line = list(self.coordinate)
            line[dim] = slice(None)
            group = backend = None
            if device_mesh is not None:
                group = device_mesh.get_group(name)
                backend = str(dist.get_backend(group))
            self._axes[name] = Axis(
                name=name, size=self.shape[name], index=self.coordinate[dim],
                ranks=tuple(int(r) for r in grid[tuple(line)]), group=group,
                backend=backend)

    def axis(self, name: str) -> Axis:
        """This rank's view of the axis ``name``; KeyError for a name the
        mesh lacks, ValueError on a rank outside the mesh."""
        if self.coordinate is None:
            raise ValueError(f"this rank lies outside the mesh over ranks {self.ranks}")
        if name not in self._axes:
            raise KeyError(f"axis {name!r} is not in the mesh {self.axis_names}")
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={list(self.ranks)}, device={self.device})"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_for(device, local_ranks: int) -> str:
    """The process group's backend for ranks on ``device``: NCCL when each
    of the host's ``local_ranks`` ranks has its own card, gloo on the CPU
    and for ranks that share a card (NCCL refuses two ranks on one)."""
    device = torch.device(device)
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def build_mesh(axes: MeshAxes, ranks: Sequence[int] | None = None, device="cuda") -> Mesh:
    """A Mesh over ``ranks`` (default: every rank of the world; one rank
    without ``torch.distributed``), each rank on ``device``.

    A mesh over a subset is allowed, as in the JAX package: it takes the
    first prod(sizes) ranks. Every rank of the world must call this, in the
    same order as its other group constructions: the DeviceMesh builds one
    process group per axis line."""
    ranks = list(range(_world())) if ranks is None else [int(r) for r in ranks]
    axes = _check_sizes(axes, len(ranks))
    ranks = ranks[: int(np.prod([s for _, s in axes])) if axes else 1]
    if ranks != sorted(ranks):
        raise ValueError(f"mesh ranks must ascend (a group's rank order), got {ranks}")
    if not dist.is_initialized() or not axes:
        return Mesh(axes, ranks, device)
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(s for _, s in axes))
    device_mesh = DeviceMesh(torch.device(device).type, grid,
                             mesh_dim_names=tuple(n for n, _ in axes))
    return Mesh(axes, ranks, device, device_mesh)


def local_mesh(axes: MeshAxes | None = None, device="cuda") -> Mesh:
    """A mesh over this host's ranks; default one "data" axis. Building a
    mesh is collective over the world, so the world must be this host
    (``LOCAL_WORLD_SIZE`` equal to the world size, as ``torchrun`` sets
    it on one node)."""
    world = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local != world:
        raise ValueError(f"local_mesh needs the whole world on this host: "
                         f"{local} local ranks of {world}")
    if axes is None:
        axes = [("data", local)]
    return build_mesh(axes, device=device)


def topology_from_registry(entries: Mapping[str, str]) -> dict[str, MeshCoord]:
    """Controller ID -> mesh coordinate from registry entries.

    ``entries`` is the {path: value} map of a registry read; only
    ``<id>/mesh`` keys participate.
    """
    topo: dict[str, MeshCoord] = {}
    for path, value in entries.items():
        parts = path.split("/")
        if len(parts) == 2 and parts[1] == REGISTRY_MESH:
            topo[parts[0]] = MeshCoord.parse(value)
    return topo


def mesh_from_topology(
    topology: Mapping[str, MeshCoord],
    axes: MeshAxes,
    ranks: Sequence[int] | None = None,
    device="cuda",
) -> Mesh:
    """A mesh whose rank order follows the registry's coordinates. A GPU
    rank carries no torus coordinate to check against the registry's, so
    ranks are ordered by rank, as the JAX package orders devices by id off
    a TPU, and ``topology`` only names the controllers."""
    ranks = sorted(range(_world()) if ranks is None else ranks)
    return build_mesh(axes, ranks, device)


def default_axes(
    n_devices: int,
    data: int = 0,
    fsdp: int = 1,
    seq: int = 1,
    model: int = 1,
) -> list[tuple[str, int]]:
    """Fill the ``data`` axis with whatever the other axes leave over."""
    rest = fsdp * seq * model
    if data == 0:
        if n_devices % rest:
            raise ValueError(f"{n_devices} devices not divisible by {rest}")
        data = n_devices // rest
    return [("data", data), ("fsdp", fsdp), ("seq", seq), ("model", model)]
