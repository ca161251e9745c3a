"""Collectives over named mesh axes (``oim_tpu/parallel/collectives.py``).

In the JAX package XLA emits these from ``lax`` primitives under
``shard_map``; here each is an explicit ``torch.distributed`` call on the
process group of one mesh axis (``Mesh.axis(name)``, parallel/mesh.py).
Every rank of the axis's group must make the same calls in the same
order, as every SPMD program does.

The ones that sit on a differentiated path (ring attention rotates K/V,
Ulysses swaps sequence for heads, FSDP gathers weights) are
``torch.autograd.Function``s whose backward is the JAX transpose:
``ppermute_ring`` rotates the other way, ``all_to_all`` swaps split and
concat, ``all_gather`` reduce-scatters and ``reduce_scatter`` gathers,
``psum`` sums the cotangents (``pmean`` averages them).

Tensor parallelism (Megatron's split) uses a conjugate pair instead of
``psum``: ``copy_to`` (identity forward, psum backward) where a
replicated activation enters a region whose ranks each hold a slice of
the weights, and ``reduce_from`` (psum forward, identity backward) where
their partial products leave it. Past ``reduce_from`` the cotangent is
the same on every rank of the axis, so a psum there (``psum``'s own
backward) would multiply every gradient below it by the axis size.
``gather_from`` is ``all_gather``'s conjugate in the same sense: where
every rank of the axis goes on with the gathered tensor and its cotangent
is whole and the same on each of them (an MoE router's columns gathered
over the ``expert`` axis), the backward keeps this
rank's slice and sums nothing; ``all_gather``'s reduce-scatter would
multiply the gradient by the axis size. ``pmax`` is forward only (the
softmax shift of the vocab-parallel loss, taken on a value with no
gradient).

Backends. NCCL carries CUDA tensors when each rank has its own card, gloo
carries CPU tensors and also CUDA tensors of ranks that share a card. What
a backend cannot take on the device goes through pinned host memory: the
choice is the table ``HOST_STAGED``, keyed on the group's backend and read
once for each call, never a retry after a failure, and NCCL stages
nothing. On torch 2.11 with CUDA 12.8, gloo takes all_reduce, broadcast,
all_gather, reduce_scatter and all_to_all on CUDA tensors and refuses
send/recv (its TCP pair writes from the device pointer), so only the ring
rotation and the pipeline's point-to-point hand-offs (``send_recv``) are
staged. ``CALLS``/``BYTES`` count every call with a group and the bytes it
sent (a ``send`` each tensor sent), ``STAGED_CALLS``/``STAGED_BYTES`` the
staged ones.

An axis without a group (a mesh of one process that never initialised
``torch.distributed``) makes every collective the identity. An axis of
size 1 with a group still calls its backend, except the rotation, which
has no peer.
"""

from __future__ import annotations

from collections.abc import Iterable

import torch
import torch.distributed as dist

from oim_tpu_torch.parallel.mesh import Axis

# backend -> operations it cannot take on a CUDA tensor (staged through
# pinned host buffers). NCCL takes every operation on the device.
HOST_STAGED = {"gloo": frozenset({"ppermute", "send"})}

OPS = ("psum", "pmax", "all_gather", "gather_from", "reduce_scatter", "all_to_all",
       "ppermute", "send")
CALLS = {op: 0 for op in OPS}
BYTES = {op: 0 for op in OPS}
STAGED_CALLS = {op: 0 for op in OPS}
STAGED_BYTES = {op: 0 for op in OPS}


def reset_counts() -> None:
    for table in (CALLS, BYTES, STAGED_CALLS, STAGED_BYTES):
        for op in table:
            table[op] = 0


def _staged(op: str, axis: Axis, x: torch.Tensor) -> bool:
    """Count the call; True when it goes through host memory."""
    nbytes = x.numel() * x.element_size()
    CALLS[op] += 1
    BYTES[op] += nbytes
    staged = x.is_cuda and op in HOST_STAGED.get(axis.backend, ())
    if staged:
        STAGED_CALLS[op] += 1
        STAGED_BYTES[op] += nbytes
    return staged


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _axes(axes) -> list[Axis]:
    return [axes] if isinstance(axes, Axis) else list(axes)


# ----------------------------------------------------------- raw ops ----


def _psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.group is None:
        return x
    y = x.contiguous().clone()
    _staged("psum", axis, y)
    dist.all_reduce(y, group=axis.group)
    return y


def _pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.group is None:
        return x
    y = x.contiguous().clone()
    _staged("pmax", axis, y)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis.group)
    return y


def _all_gather(x: torch.Tensor, axis: Axis, dim: int, op: str = "all_gather") -> torch.Tensor:
    if axis.group is None:
        return x
    x = x.contiguous()
    _staged(op, axis, x)
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim)


def _check_split(x: torch.Tensor, axis: Axis, dim: int, what: str) -> None:
    if x.shape[dim] % axis.size:
        raise ValueError(f"{what}: dim {dim} of shape {tuple(x.shape)} does not divide "
                         f"into the {axis.name!r} axis size {axis.size}")


def _reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    if axis.group is None:
        return x
    _check_split(x, axis, dim, "reduce_scatter")
    _staged("reduce_scatter", axis, x)
    chunks = [c.contiguous() for c in x.chunk(axis.size, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=axis.group)
    return out


def _all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    if axis.group is None:
        return x
    _check_split(x, axis, split_dim, "all_to_all")
    send = torch.stack(x.chunk(axis.size, split_dim)).contiguous()
    _staged("all_to_all", axis, send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), concat_dim)


def _ppermute(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    if axis.group is None or shift % axis.size == 0:
        return x
    x = x.contiguous()
    staged = _staged("ppermute", axis, x)
    send = _to_host(x) if staged else x
    recv = torch.empty_like(send)
    n, i = axis.size, axis.index
    ops = [dist.P2POp(dist.isend, send, axis.ranks[(i + shift) % n], group=axis.group),
           dist.P2POp(dist.irecv, recv, axis.ranks[(i - shift) % n], group=axis.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


def send_recv(axis: Axis, sends=(), recvs=(), device=None) -> list[torch.Tensor]:
    """Point-to-point over ``axis`` (no gradient): ``sends`` are
    (tensor, index on the axis, tag) and ``recvs`` (shape, dtype, index,
    tag) of the tensors to receive on ``device``; every operation is
    posted at once and waited, and the received tensors come back in
    ``recvs``' order. A send to this rank's own index is handed to the
    receive of the same tag without a call. The peer of each send must
    post its receive in the same call, and two ranks order the messages
    between them alike (sends and receives both in the order of their
    tags): messages between a pair match in order."""
    local = {tag: t for t, peer, tag in sends if peer == axis.index}
    ops, bufs = [], []
    for t, peer, tag in sends:
        if peer == axis.index:
            continue
        t = t.contiguous()
        staged = _staged("send", axis, t)
        ops.append(dist.P2POp(dist.isend, _to_host(t) if staged else t, axis.ranks[peer],
                              group=axis.group, tag=tag))
    recv_staged = (torch.device(device).type == "cuda"
                   and "send" in HOST_STAGED.get(axis.backend, ()))
    for shape, dtype, peer, tag in recvs:
        if peer == axis.index:
            bufs.append((local.pop(tag), False))
            continue
        buf = torch.empty(shape, dtype=dtype, device="cpu" if recv_staged else device,
                          pin_memory=recv_staged)
        ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[peer], group=axis.group, tag=tag))
        bufs.append((buf, recv_staged))
    if local:
        raise ValueError(f"sends to this rank with no receive: tags {sorted(local)}")
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(device) if on_host else b for b, on_host in bufs]


# -------------------------------------------- differentiable wrappers ----


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim, "gather_from")

    @staticmethod
    def backward(ctx, g):
        if ctx.axis.group is None:
            return g, None, None
        _check_split(g, ctx.axis, ctx.dim, "gather_from")
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.index].contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.axis, concat_dim, split_dim), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.axis, -ctx.shift), None, None


# --------------------------------------------------------- public API ----


def psum(x: torch.Tensor, axes: Axis | Iterable[Axis]) -> torch.Tensor:
    """Sum over one axis or several (one after another, which sums over
    their product)."""
    for axis in _axes(axes):
        x = _Psum.apply(x, axis)
    return x


def pmean(x: torch.Tensor, axes: Axis | Iterable[Axis]) -> torch.Tensor:
    axes = _axes(axes)
    n = 1
    for axis in axes:
        n *= axis.size
    return psum(x, axes) / n


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` unchanged, entering a tensor-parallel region over ``axis``:
    the backward sums the ranks' partial cotangents (a psum)."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial products, leaving a
    tensor-parallel region: the backward passes the (replicated)
    cotangent through unchanged."""
    return _ReduceFrom.apply(x, axis)


@torch.no_grad()
def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise max over ``axis`` (no gradient)."""
    return _pmax(x.detach(), axis)


def all_gather(x: torch.Tensor, axis: Axis, *, tiled: bool = True,
               gather_dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``gather_dim`` in axis order: concatenated
    when ``tiled``, else stacked in a new dim there."""
    if not tiled:
        x = x.unsqueeze(gather_dim)
    return _AllGather.apply(x, axis, gather_dim)


def gather_from(x: torch.Tensor, axis: Axis, *, gather_dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``gather_dim`` in axis order (tiled), for a
    tensor every rank of the axis then uses whole: the backward takes this
    rank's slice of the cotangent, which is already the same on every rank,
    and sums nothing (Megatron's gather, the conjugate of
    ``reduce_scatter``)."""
    return _GatherFrom.apply(x, axis, gather_dim)


def reduce_scatter(x: torch.Tensor, axis: Axis, *, scatter_dim: int = 0) -> torch.Tensor:
    """The sum over the axis of ``x``, of which this rank keeps its
    ``1/size`` slice along ``scatter_dim`` (tiled)."""
    return _ReduceScatter.apply(x, axis, scatter_dim)


def all_to_all(x: torch.Tensor, axis: Axis, *, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split ``split_dim`` into ``size`` chunks, send chunk j to rank j,
    concatenate what arrives along ``concat_dim`` in axis order (tiled)."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def ppermute_ring(x: torch.Tensor, axis: Axis, *, shift: int = 1) -> torch.Tensor:
    """Rotate shards ``shift`` steps around the ring: rank i receives rank
    i - shift's ``x`` (the primitive under ring attention)."""
    return _Ppermute.apply(x, axis, shift)


def axis_index(axis: Axis) -> int:
    return axis.index


def axis_size(axis: Axis) -> int:
    return axis.size
