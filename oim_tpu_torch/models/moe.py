"""Mixture-of-Experts FFN (``oim_tpu/models/moe.py``): top-k routing with
a capacity limit, the expert SwiGLU as batched products over the experts,
and both dispatch modes of the reference.

"gather" (the default) scatters token ids into an [E, C] buffer, gathers
the tokens into the experts' inputs and each routing round's outputs
back to token positions; "einsum" is GShard's dense one-hot dispatch and
combine. The two give the same numbers (``tests/test_torch_moe.py``).

Every shape is static and nothing syncs the host: a token over capacity
is dropped by index arithmetic, never by a boolean mask or ``nonzero``.
The reference's ``.at[].set(mode="drop")`` sends a dropped token to the
out-of-range slot C; torch raises on such an index, so the gather
buffers carry a dump column C that is sliced off.

The router runs in float32 with autocast off and refuses TF32: a route is
an argmax, which a low-precision product can flip. Expert products run in
the model dtype and lower to ``aten.bmm``, so remat's
"dots_with_no_batch_dims" recomputes them as JAX's policy does (batch dim
E).

Under a mesh (``MeshContext``) the layer computes what the JAX step
computes on the global batch, whose one jitted function routes every
token of it at once:

* Routing is global. The capacity comes from the global token count, and
  a token's slot is its rank among all tokens routed to its expert in the
  global row-major (b, t) order. Each rank gathers the router
  probabilities of the axes that split the tokens (data, fsdp, seq; a
  zigzag seq rank holds two chunks of each row), puts them in that order,
  routes the whole set (deterministic: the ranks agree) and keeps its own
  rows. The gates come from the rank's own probabilities, so the
  gradient stays local.
* The load-balance loss and the drop share are this rank's shares: they
  sum over the token-splitting axes to the global values, as the
  trainer's loss shares do.
* Expert parallelism (``param_logical_axes``' EXPERT, the "expert" mesh
  axis under ``TP_SP_RULES``): the ranks of the axis hold the same tokens
  and E/n experts each, and the router's columns of those experts. The
  router's columns are gathered with ``gather_from`` and every rank takes
  the whole [N, E] product, as one rank does: the product over E/n
  columns rounds otherwise in the last bit, and a route that turns on it
  would part the ranks from one rank's run. The tokens enter the experts
  through ``copy_to``, each rank runs its own experts, and the partial
  outputs leave through ``reduce_from``; the combine weights enter
  through ``copy_to`` too, so the cotangent of the logits, and of the
  gathered router, is whole on every rank. No all-to-all is needed.
  Under a ``model`` axis each expert's MLP is split Megatron's way
  (w_gate and w_up by column, w_down by row) inside the same region; the
  router, replicated over ``model``, stays outside it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from oim_tpu_torch.common import tracing
from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.ring import shard_positions
from oim_tpu_torch.parallel.sharding import EMBED, EXPERT, LAYER, MLP


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dispatch: str = "gather"  # or "einsum"


def init(rng: torch.Generator, dim: int, mlp_dim: int, cfg: MoEConfig, dtype,
         n_layers: int | None = None, device=None) -> dict:
    """Expert FFN params drawn from ``rng``; with n_layers, stacked
    [L, ...]. The router is float32 whatever ``dtype``."""
    device = rng.device if device is None else torch.device(device)
    lead = () if n_layers is None else (n_layers,)
    e = cfg.n_experts
    fan = dim ** -0.5

    def normal(shape, scale, dt):
        x = torch.randn(lead + shape, generator=rng, dtype=torch.float32, device=device)
        return (x * scale).to(dt)

    return {
        "router": normal((dim, e), fan, torch.float32),
        "w_gate": normal((e, dim, mlp_dim), fan, dtype),
        "w_up": normal((e, dim, mlp_dim), fan, dtype),
        "w_down": normal((e, mlp_dim, dim), mlp_dim ** -0.5, dtype),
    }


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Where the layer runs under a mesh: ``batch``, the axes of more than
    one rank that split the global batch's rows (outer first, as the
    BATCH rule lists them); ``seq``, the axis that splits each row's
    positions, laid out by ``layout`` (``ring.shard_positions``: "ring"
    contiguous, "zigzag" two chunks); ``model``, the tensor-parallel axis;
    ``expert``, the axis the experts are split over. Each is None (or
    empty) where the mesh does not split that way. ``groups``: the rank's
    rows are that many consecutive blocks, block m its part of the global
    batch's m-th block (a batch placed in accumulation microbatches and
    run whole, as an eval pass runs it)."""

    batch: tuple = ()
    seq: Any = None
    layout: str = "ring"
    model: Any = None
    expert: Any = None
    groups: int = 1


def param_logical_axes(stacked: bool = False) -> dict:
    """Each leaf's dims by logical name, the tree of ``init``."""
    lead = (LAYER,) if stacked else ()
    return {
        "router": lead + (EMBED, EXPERT),
        "w_gate": lead + (EXPERT, EMBED, MLP),
        "w_up": lead + (EXPERT, EMBED, MLP),
        "w_down": lead + (EXPERT, MLP, EMBED),
    }


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return max(1, int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts))


def _router_logits(tokens, router):
    """tokens @ router in true float32."""
    if tokens.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "MoE routing needs full-float32 products: TF32 is on "
            "(torch.set_float32_matmul_precision / allow_tf32)")
    with torch.autocast(tokens.device.type, enabled=False):
        return tokens.float() @ router.float()


def _router_probs(tokens, router):
    """softmax(tokens @ router) in true float32."""
    return torch.softmax(_router_logits(tokens, router), dim=-1)


def router_margin(router, x, k: int, set_only: bool = False) -> torch.Tensor:
    """How far the routes of ``x`` are from a tie: over tokens, the least
    gap between consecutive router probabilities among the top k+1 (a 0-d
    tensor). ``set_only`` takes only the gap between the k-th and the next,
    the one that decides which experts run when nothing is dropped. A route
    whose margin is below the noise of the arithmetic can flip between two
    devices or batch shapes. A diagnostic: ``apply`` never calls it."""
    with torch.no_grad():
        probs = _router_probs(x.reshape(-1, router.shape[0]), router)
        top = probs.sort(dim=-1, descending=True).values
        gaps = top[:, :-1] - top[:, 1:]
        return (gaps[:, k - 1] if set_only else gaps[:, :k]).min()


def _one_hot(idx, n: int, dtype):
    """[N] -> [N, n]. F.one_hot checks its indices with ``.item()`` on the
    CPU; a comparison checks nothing and never syncs."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _assign(probs, k: int, cap: int):
    """The top-k rounds' decisions over the token set of ``probs`` [N, E]
    (no gradient): per round (expert, pos, keep), [N] each. argmax takes
    the first of tied experts; a token's slot is its rank among this
    round's tokens of its expert after the slots earlier rounds filled;
    ``keep`` is pos < cap, and pos is then clipped."""
    e = probs.shape[-1]
    remaining = probs.detach()
    fill = torch.zeros(e, dtype=torch.long, device=probs.device)
    rounds = []
    for _ in range(k):
        expert = remaining.argmax(dim=-1)
        onehot = _one_hot(expert, e, torch.long)  # [N, E]
        pos = ((onehot.cumsum(dim=0) - 1 + fill) * onehot).sum(dim=-1)
        keep = pos < cap
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        rounds.append((expert, pos.clamp(0, cap - 1), keep))
        remaining = remaining * (1.0 - onehot.float())
    return rounds


def _gates(probs, rounds):
    """Each round's combine weight [N] (its gate where kept, else 0) from
    this rank's ``probs`` [N, E], which carry the gradient. k > 1
    renormalises over the experts used (GShard); k == 1 keeps the raw
    router probability (Switch): a gate of 1 would carry no gradient."""
    gates = [probs.gather(1, expert[:, None])[:, 0] for expert, _, _ in rounds]
    if len(rounds) > 1:
        denom = sum(torch.where(keep, g, 0.0) for g, (_, _, keep) in zip(gates, rounds))
        denom = torch.clamp(denom, min=1e-9)
        gates = [g / denom for g in gates]
    return [g * keep for g, (_, _, keep) in zip(gates, rounds)]


def _global_tokens(x, ctx: MeshContext):
    """This rank's [b, t, ...] -> (the global token set's [B*T, ...] in the
    JAX step's row-major (b, t) order, the global indices of this rank's
    b*t tokens in x's order). Gathered over the axes that split the tokens;
    no gradient."""
    b, t = x.shape[:2]
    rest = tuple(x.shape[2:])
    y = x.detach()
    n_seq = ctx.seq.size if ctx.seq is not None else 1
    span = t * n_seq
    dev = x.device
    if n_seq > 1:
        parts = collectives.all_gather(y, ctx.seq, tiled=False, gather_dim=0)
        where = np.concatenate([shard_positions(span, n_seq, i, ctx.layout)
                                for i in range(n_seq)])
        full = torch.empty((b, span) + rest, dtype=y.dtype, device=dev)
        full[:, torch.from_numpy(where.astype(np.int64)).to(dev)] = (
            parts.transpose(0, 1).reshape((b, span) + rest))
        y = full
        mine = shard_positions(span, n_seq, ctx.seq.index, ctx.layout)
    else:
        mine = np.arange(t)
    piece, pieces = 0, 1
    for axis in ctx.batch:
        piece, pieces = piece * axis.size + axis.index, pieces * axis.size
    for axis in reversed(ctx.batch):  # innermost first, as Sharding.gather
        y = collectives.all_gather(y, axis, gather_dim=0)

    def global_rows(p):  # piece p's local rows -> their global rows
        block = b // ctx.groups
        i = np.arange(b)
        return (i // block) * (pieces * block) + p * block + i % block

    order = np.concatenate([global_rows(p) for p in range(pieces)])
    if pieces > 1 and ctx.groups > 1:
        y = y[torch.from_numpy(np.argsort(order).astype(np.int64)).to(dev)]
    index = (global_rows(piece)[:, None] * span + np.asarray(mine)[None, :]).reshape(-1)
    return y.reshape((-1,) + rest), torch.from_numpy(index.astype(np.int64)).to(dev)


def _expert_ffn(params, expert_in):
    """[E, C, D] -> [E, C, D]: the SwiGLU of each expert, shared by both
    dispatch modes."""
    h = F.silu(torch.bmm(expert_in, params["w_gate"])) * torch.bmm(expert_in, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _local(expert, keep, e: int, e0: int):
    """(this rank's index of each token's expert, clamped into range; keep
    where that expert is this rank's): the ``e`` experts from ``e0``."""
    here = keep & (expert >= e0) & (expert < e0 + e)
    return (expert - e0).clamp(0, e - 1), here


def _gather_dispatch(params, tokens, rounds, e: int, e0: int, cap: int):
    n, d = tokens.shape
    dev = tokens.device
    ids = torch.arange(n, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    # Column `cap` is the dump slot of dropped tokens (and, under expert
    # parallelism, of tokens routed to another rank's experts); each real
    # (expert, pos) pair is written at most once across rounds.
    idx_buf = torch.zeros(e, cap + 1, dtype=torch.long, device=dev)
    valid = torch.zeros(e, cap + 1, dtype=torch.bool, device=dev)
    for _, expert, pos, keep in rounds:
        local, here = _local(expert, keep, e, e0)
        pos_w = torch.where(here, pos, cap)
        idx_buf = idx_buf.index_put((local, pos_w), ids)
        valid = valid.index_put((local, pos_w), true)
    idx_buf, valid = idx_buf[:, :cap], valid[:, :cap]
    expert_in = tokens.index_select(0, idx_buf.reshape(-1)).reshape(e, cap, d)
    expert_in = expert_in * valid[..., None].to(tokens.dtype)
    flat_out = _expert_ffn(params, expert_in).reshape(e * cap, d)
    out = torch.zeros(n, d, dtype=tokens.dtype, device=dev)
    for w, expert, pos, keep in rounds:
        local, here = _local(expert, keep, e, e0)
        picked = flat_out.index_select(0, local * cap + pos)
        out = out + picked * (w * here).to(tokens.dtype)[:, None]
    return out


def _einsum_dispatch(params, tokens, rounds, e: int, e0: int, cap: int):
    n = tokens.shape[0]
    combine = torch.zeros(n, e, cap, dtype=torch.float32, device=tokens.device)
    dispatch = torch.zeros(n, e, cap, dtype=torch.bool, device=tokens.device)
    for w, expert, pos, keep in rounds:
        onehot = _one_hot(expert - e0, e, torch.float32)  # zero off this rank
        slot = _one_hot(pos, cap, torch.float32)
        contrib = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
        combine = combine + w[:, None, None] * contrib
        dispatch = dispatch | (contrib > 0)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(tokens.dtype), tokens)
    return torch.einsum("nec,ecd->nd", combine.to(tokens.dtype),
                        _expert_ffn(params, expert_in))


_DISPATCH = {"gather": _gather_dispatch, "einsum": _einsum_dispatch}


def apply(params, x, cfg: MoEConfig, with_stats: bool = False,
          ctx: MeshContext | None = None):
    """x [B, T, D] -> (out [B, T, D], aux). ``aux`` is the f32 load-balance
    loss, or with ``with_stats`` the f32 vector [aux, dropped], dropped
    being the share of the N*k routing assignments over capacity (no
    gradient). A dropped assignment contributes zero; the residual
    stream carries its token.

    ``ctx`` places the layer under a mesh: ``x`` is this rank's tokens
    (replicated over the ``model`` and ``expert`` axes) and ``params`` its
    pieces; ``out`` comes out whole on every rank, and aux and dropped are
    this rank's shares of the global values. On a torch profiler's trace
    the layer is a ``moe.forward`` range (``tracing.device_range``)."""
    with tracing.device_range("moe.forward"):
        return _apply(params, x, cfg, with_stats, ctx)


def _apply(params, x, cfg: MoEConfig, with_stats: bool, ctx: MeshContext | None):
    if cfg.dispatch not in _DISPATCH:
        raise ValueError(f"unknown MoE dispatch mode {cfg.dispatch!r} "
                         "(valid: 'gather', 'einsum')")
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    ctx = ctx or MeshContext()
    ep, tp = ctx.expert, ctx.model
    tokens = x.reshape(n, d)
    router = params["router"]
    if ep is not None:
        router = collectives.gather_from(router, ep, gather_dim=1)
    probs = torch.softmax(_router_logits(tokens, router), dim=-1)
    if ctx.batch or ctx.seq is not None:
        every, mine = _global_tokens(probs.reshape(b, t, e), ctx)
        n_all = every.shape[0]
        cap = capacity(n_all, cfg)
        rounds = [tuple(a.index_select(0, mine) for a in r) for r in _assign(every, k, cap)]
        top1 = every.argmax(dim=-1)
    else:
        n_all, cap = n, capacity(n, cfg)
        rounds = _assign(probs, k, cap)
        top1 = probs.argmax(dim=-1)
    weights = _gates(probs, rounds)
    if ep is not None or tp is not None:
        # Each rank's combine holds its own experts' outputs only: the
        # weights' cotangent is summed back over the region.
        stacked = torch.stack(weights)
        for axis in (ep, tp):
            if axis is not None:
                stacked = collectives.copy_to(stacked, axis)
        weights = list(stacked.unbind(0))
    rounds = [(w, *r) for w, r in zip(weights, rounds)]
    for axis in (ep, tp):
        if axis is not None:
            tokens = collectives.copy_to(tokens, axis)
    e_here = params["w_gate"].shape[0]
    e0 = ep.index * e_here if ep is not None else 0
    out = _DISPATCH[cfg.dispatch](params, tokens, rounds, e_here, e0, cap)
    for axis in (tp, ep):
        if axis is not None:
            out = collectives.reduce_from(out, axis)
    out = out.reshape(b, t, d)

    # Switch Transformer's load-balance loss: E * sum_e (share of tokens
    # whose top expert is e) * (mean router probability of e), over the
    # global token set; this rank's share sums its own probabilities.
    frac_tokens = _one_hot(top1, e, torch.float32).mean(dim=0)
    aux = e * torch.sum(frac_tokens * probs.sum(dim=0)) / n_all
    if not with_stats:
        return out, aux
    kept = sum(keep.float().sum() for _, _, _, keep in rounds)
    dropped = ((n * k - kept) / (n_all * k)).detach()
    return out, torch.stack([aux, dropped])
