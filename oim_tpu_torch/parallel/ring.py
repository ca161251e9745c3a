"""Sequence parallelism for long context (``oim_tpu/parallel/ring.py``):
ring attention, its zigzag load-balanced form, and Ulysses.

Long sequences are split over the ``seq`` mesh axis; every function here
takes this rank's shards [B, T_local, H, D] (K/V at kv-head width: GQA is
never expanded except by Ulysses' fallback) and the ``Axis``
(``Mesh.axis("seq")``) to communicate over.

- **Ring** (``ring_attention``): K/V shards rotate around the ring with
  ``ppermute_ring`` while each rank merges its queries' attention over the
  held block into a running (out, lse) pair. Each block is one call of
  ``ops.attention.attention_with_lse``, so K1 runs it forward and K2/K3
  backward on the card, the lse cotangent entering K2/K3 as
  ``delta - g_lse``. Under the causal mask a held block is the diagonal
  (causal kernel), wholly visible (unmasked kernel) or wholly hidden:
  skipped, launching nothing.
- **Zigzag** (``zigzag_ring_attention``): rank i holds global slices i and
  2n-1-i of 2n (``zigzag_permutation``), so every rank runs one kernel of
  equal work per step (``zigzag_schedule``).
- **Ulysses** (``ulysses_attention``): two ``all_to_all``s swap the split
  from sequence to heads and back, with one local attention in between.

The JAX package runs these under ``shard_map`` on global arrays and has
``make_sequence_parallel_attention`` permute into the zigzag layout and
back. In the port each rank already holds its shard, in the layout its
kind uses: the trainer cuts a zigzag rank's tokens by
``shard_positions``, and RoPE takes those global positions.

Autograd runs backward through the rotation on every rank. A rank that
skips a hidden block still ties that block's K/V to its output through
``_Keep`` (a zero gradient), so every rank runs every rotation's backward
and the ring's sends and receives pair up.
"""

from __future__ import annotations

import numpy as np
import torch

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.ops.attention import _expand_gqa, attention, attention_with_lse
from oim_tpu_torch.parallel.collectives import all_to_all, ppermute_ring
from oim_tpu_torch.parallel.mesh import Axis

NEG_INF = -1e30


def _merge(o, lse, o_blk, lse_blk):
    """Blockwise-softmax accumulator merge: combine a block's (out, lse)
    into the running pair through their logsumexps. NEG_INF is finite
    (-1e30), so an all-masked neutral element stays NaN-free, forward and
    backward."""
    lse_new = torch.logaddexp(lse, lse_blk)
    o = (o * torch.exp(lse - lse_new)[..., None]
         + o_blk * torch.exp(lse_blk - lse_new)[..., None])
    return o, lse_new


class _Keep(torch.autograd.Function):
    """``x``, with ``dep`` in its graph at zero gradient."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _start(q):
    b, t, h, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((b, t, h), NEG_INF, dtype=torch.float32, device=q.device))


def _ring(q, k, v, axis: Axis, block):
    """The ring loop: ``block(o, lse, k_cur, v_cur, src) -> (o, lse)`` for
    each held K/V shard (its owner ``src``), rotating K and V together
    between blocks (n - 1 rotations)."""
    n, my = axis.size, axis.index
    o, lse = _start(q)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (my - i) % n
        k_cur, v_cur = kv.unbind(0)
        o, lse = block(o, lse, k_cur, v_cur, src, kv)
        if i + 1 < n:
            kv = ppermute_ring(kv, axis)
    return o.to(q.dtype)


def ring_attention(q, k, v, axis: Axis, causal: bool = True):
    """Ring attention over ``axis``; q/k/v are contiguous sequence shards
    (rank i holds positions [i*T_local, (i+1)*T_local)). Returns
    [B, T_local, H, D] in q's dtype."""
    scale = q.shape[-1] ** -0.5
    my = axis.index

    def block(o, lse, k_cur, v_cur, src, kv):
        if causal and src > my:  # wholly in the future: no kernel
            return _Keep.apply(o, kv), lse
        o_blk, lse_blk = attention_with_lse(q, k_cur, v_cur, causal=causal and src == my,
                                            scale=scale)
        return _merge(o, lse, o_blk, lse_blk)

    return _ring(q, k, v, axis, block)


def zigzag_permutation(seq_len: int, n: int) -> np.ndarray:
    """Global seq order for the zigzag layout: the sequence splits into 2n
    equal slices and rank i holds slices (i, 2n-1-i), so under the causal
    mask every rank owns one early and one late slice and per-step ring
    work is equal across ranks."""
    if seq_len % (2 * n):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*{n}")
    s = seq_len // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * s, (i + 1) * s))
        order.extend(range((2 * n - 1 - i) * s, (2 * n - i) * s))
    return np.asarray(order, dtype=np.int32)


def zigzag_schedule(n: int):
    """The half-slice block pairs each (rank, ring step) computes:
    {(rank, step): [(q_slice, kv_slice, "diag"|"full"), ...]}: the branch
    logic of ``zigzag_ring_attention`` written down as data."""
    out = {}
    for chip in range(n):
        ql, qh = chip, 2 * n - 1 - chip
        for step in range(n):
            src = (chip - step) % n
            kl, kh = src, 2 * n - 1 - src
            if src == chip:
                # Local causal over the concatenated (low ++ high) block:
                # low-diag, high-sees-low, high-diag.
                pairs = [(ql, kl, "diag"), (qh, kl, "full"), (qh, kh, "diag")]
            elif src < chip:
                # Both query halves are later than the held low slice;
                # the held high slice is later than both.
                pairs = [(ql, kl, "full"), (qh, kl, "full")]
            else:
                # Only the high query half sees anything: both held
                # slices sit between q_low and q_high.
                pairs = [(qh, kl, "full"), (qh, kh, "full")]
            out[(chip, step)] = pairs
    return out


def zigzag_ring_attention(q, k, v, axis: Axis, causal: bool = True):
    """Load-balanced causal ring attention over zigzag shards (rank i holds
    global slices i and 2n-1-i back to back). One kernel per ring step:
    the diagonal step a local causal block, each other step an unmasked
    rectangle of two half-slice pairs."""
    if not causal:
        # Without a mask every layout is balanced; plain ring serves it.
        return ring_attention(q, k, v, axis, causal=False)
    scale = q.shape[-1] ** -0.5
    my = axis.index
    t_local = q.shape[1]
    if t_local % 2:
        raise ValueError(
            f"zigzag shards hold two equal half-slices; local seq length "
            f"{t_local} is odd (global seq must divide 2*axis_size)"
        )
    t2 = t_local // 2
    q_hi = q[:, t2:]

    def block(o, lse, k_cur, v_cur, src, kv):
        if src == my:
            # The lower-triangular mask over the concatenated halves is
            # exactly the zigzag causal structure.
            return _merge(o, lse, *attention_with_lse(q, k_cur, v_cur, causal=True,
                                                      scale=scale))
        if src < my:
            # Both query halves attend the held LOW slice only.
            return _merge(o, lse, *attention_with_lse(
                q, k_cur[:, :t2], v_cur[:, :t2], causal=False, scale=scale))
        # src > my: only the high query half attends, to both held slices;
        # the low half's neutral element would leave it as it is.
        o_hi, lse_hi = _merge(o[:, t2:], lse[:, t2:], *attention_with_lse(
            q_hi, k_cur, v_cur, causal=False, scale=scale))
        return torch.cat([o[:, :t2], o_hi], 1), torch.cat([lse[:, :t2], lse_hi], 1)

    return _ring(q, k, v, axis, block)


_FALLBACK_WARNED: set[tuple[int, int]] = set()


def ulysses_attention(q, k, v, axis: Axis, causal: bool = True):
    """All-to-all (DeepSpeed-Ulysses-style) sequence-parallel attention on
    contiguous shards: seq -> heads, one local attention over the full
    sequence for H/n heads, heads -> seq.

    GQA-native when the axis size divides the kv heads: rank j receives
    exactly the kv heads its query heads need. Otherwise K/V are expanded
    to query-head width first (n times the bytes), with a warning once
    for each (kv heads, axis size)."""
    size = axis.size
    if q.shape[2] % size:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"{axis.name!r} axis size ({size})"
        )
    if k.shape[2] % size:
        if (k.shape[2], size) not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add((k.shape[2], size))
            from_context().warning(
                "ulysses GQA fallback: expanding K/V to query-head width",
                kv_heads=k.shape[2], axis_size=size,
                hint="make kv_heads divisible by the seq axis, or use ring",
            )
        k, v = _expand_gqa(q, k, v)

    def seq_to_heads(x):  # [B, T/s, H, D] -> [B, T, H/s, D]
        return all_to_all(x, axis, split_dim=2, concat_dim=1)

    def heads_to_seq(x):  # [B, T, H/s, D] -> [B, T/s, H, D]
        return all_to_all(x, axis, split_dim=1, concat_dim=2)

    out = attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal)
    return heads_to_seq(out)


KINDS = {
    "ring": ring_attention,
    "ulysses": ulysses_attention,
    "zigzag": zigzag_ring_attention,
}


def make_sequence_parallel_attention(mesh, kind: str = "ring", axis: str = "seq",
                                     causal: bool = True):
    """fn(q, k, v) on this rank's shards in ``kind``'s layout (zigzag:
    ``zigzag_permutation`` order; ring and ulysses: contiguous). The batch
    is already this rank's rows, so the JAX package's ``batch_axes`` has
    no counterpart."""
    if kind not in KINDS:
        raise ValueError(
            f"unknown sequence-parallel kind {kind!r} "
            f"(valid: {sorted(KINDS)})"
        )
    inner, ax = KINDS[kind], mesh.axis(axis)

    def fn(q, k, v):
        return inner(q, k, v, ax, causal=causal)

    return fn


def shard_positions(seq_len: int, n: int, index: int, kind: str = "ring") -> np.ndarray:
    """The global positions rank ``index`` of ``n`` holds under ``kind``'s
    layout: slices ``index`` and ``2n-1-index`` of 2n for zigzag, the
    ``index``-th contiguous run otherwise."""
    if seq_len % n:
        raise ValueError(f"seq_len {seq_len} not divisible by the seq axis size {n}")
    t = seq_len // n
    if kind == "zigzag":
        return zigzag_permutation(seq_len, n)[index * t:(index + 1) * t]
    return np.arange(index * t, (index + 1) * t, dtype=np.int32)
