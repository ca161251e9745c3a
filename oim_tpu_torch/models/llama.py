"""Llama-family decoder-only transformer (``oim_tpu/models/llama.py``):
RMSNorm / RoPE / SwiGLU / GQA, with the Mixture-of-Experts FFN of
``models/moe.py`` in place of the dense one when ``n_experts > 0``.

The param tree keeps the JAX package's layout, so weights carry across
unchanged: layer weights are STACKED along a leading [L, ...] axis (an MoE
model's under ``layers["moe"]``) and ``hidden_states`` loops over the
layer index (the JAX package scans). The default attention is
``ops.attention.attention``: the Hopper flash kernels on CUDA, their plain
versions on the CPU. bf16 params and activations; the router, logits,
softmax statistics and loss in f32.

``remat`` recomputes each layer in the backward pass under
``remat_policy`` (``models/remat.py``). ``param_logical_axes`` names each
weight's dims for the sharding rules (``parallel/sharding.py``), the MoE
subtree's with the EXPERT axis (``moe.param_logical_axes``).
Under sequence parallelism a rank runs the model on its shard of the
sequence: ``hidden_states`` and ``loss_and_stats`` take the shard's global
positions for RoPE, its labels (shifted before the sequence was cut) and
the global count of kept labels. ``make_pipelined_loss`` (GPipe) and
``make_1f1b_loss`` (1F1B, interleaved with ``n_virtual`` > 1) pipeline the
layers over a ``pipe`` axis and return the loss with its gradients: the
pipeline drives its own backward across ranks.

Tensor parallelism (``tp``, the ``model`` mesh axis; Megatron's split, as
``TP_SP_RULES`` lays the leaves out): each rank holds a contiguous slice
of the query and KV heads (wq/wk/wv by column, wo by row), of the MLP
(w_gate/w_up by column, w_down by row) and of the vocabulary (embed's
rows, lm_head's columns). A layer enters each half through
``copy_to`` and leaves it through ``reduce_from`` after wo and w_down; the
embedding is looked up on the local rows and summed the same way, and the
loss is ``vocab_parallel_cross_entropy`` on the local head. Where the
axis divides the query heads but not the KV heads (llama-tiny's 4/2 at
4), wk/wv are gathered over the axis and each rank takes the KV heads of
its query heads. Where it does not divide the query heads either (3 heads
over 2 ranks), the leaves are still cut evenly by columns, as the JAX
package lays them out, so a head can straddle two ranks: each rank
gathers q over the axis, attends on the whole heads that overlap its
columns, and keeps its columns of the output before wo. A straddling
head is attended on both ranks, so the gather's backward must sum every
rank's share of its cotangent (the plain ``all_gather``, which
reduce-scatters; ``gather_from`` would keep this rank's share alone).
An MoE FFN takes the mesh context
(``moe.MeshContext``): global routing, and its experts split over the
``expert`` axis and each expert's MLP over ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from oim_tpu_torch.models import moe as moelib
from oim_tpu_torch.models import remat as rematlib
from oim_tpu_torch.ops.attention import attention as default_attention
from oim_tpu_torch.ops.losses import (
    chunked_softmax_cross_entropy,
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)
from oim_tpu_torch.ops.norms import rmsnorm
from oim_tpu_torch.ops.rope import apply_rope, rope_frequencies
from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.sharding import EMBED, HEAD, KV_HEAD, LAYER, MLP, VOCAB


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: Any = torch.bfloat16
    # n_experts > 0 replaces the dense FFN with a top-k-routed expert FFN
    # (models/moe.py); dispatch "gather" (index-based) or "einsum".
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "gather"
    # Recompute each layer in the backward pass; the policy names what
    # may be kept ("", "dots", "dots_with_no_batch_dims", "nothing").
    remat: bool = False
    remat_policy: str = ""
    # vocab_chunk > 0: the training loss never materializes [B, T, vocab].
    vocab_chunk: int = 0
    # z_loss > 0 adds z_loss * mean(logsumexp^2) to the CE.
    z_loss: float = 0.0

    @property
    def moe(self) -> moelib.MoEConfig:
        return moelib.MoEConfig(n_experts=self.n_experts, top_k=self.moe_top_k,
                                capacity_factor=self.moe_capacity_factor,
                                dispatch=self.moe_dispatch)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


LLAMA3_8B = Config(vocab_chunk=16384)  # 128k-vocab logits never materialize


def tiny(vocab: int = 256, dim: int = 64, n_layers: int = 2,
         n_experts: int = 0) -> Config:
    """A test-scale config with the full architecture."""
    return Config(
        vocab=vocab, dim=dim, n_layers=n_layers, n_heads=4, n_kv_heads=2,
        head_dim=dim // 4, mlp_dim=dim * 3, max_seq=512, dtype=torch.float32,
        n_experts=n_experts,
    )


def check_supported(cfg: Config) -> None:
    """Refuse a config the port cannot run, instead of ignoring it."""
    if cfg.remat:
        rematlib.check_policy(cfg.remat_policy)


def _dense(rng: torch.Generator, shape, dtype, scale, device):
    x = torch.randn(shape, generator=rng, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init(rng: torch.Generator, cfg: Config = LLAMA3_8B, device=None) -> dict:
    """Random params drawn from ``rng`` on its device (or ``device``). The
    draws differ from ``jax.random``'s; carry JAX weights across with
    ``from_numpy`` to compare the two packages."""
    check_supported(cfg)
    device = rng.device if device is None else torch.device(device)
    L, D = cfg.n_layers, cfg.dim
    fan = D ** -0.5

    def dense(shape, scale):
        return _dense(rng, shape, cfg.dtype, scale, device)

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    embed = dense((cfg.vocab, D), 0.02)
    layers = {
        "attn_norm": ones(L, D),
        "wq": dense((L, D, cfg.q_dim), fan),
        "wk": dense((L, D, cfg.kv_dim), fan),
        "wv": dense((L, D, cfg.kv_dim), fan),
        "wo": dense((L, cfg.q_dim, D), cfg.q_dim ** -0.5),
        "mlp_norm": ones(L, D),
    }
    if cfg.n_experts:
        layers["moe"] = moelib.init(rng, D, cfg.mlp_dim, cfg.moe, cfg.dtype,
                                    n_layers=L, device=device)
    else:
        layers.update(w_gate=dense((L, D, cfg.mlp_dim), fan),
                      w_up=dense((L, D, cfg.mlp_dim), fan),
                      w_down=dense((L, cfg.mlp_dim, D), cfg.mlp_dim ** -0.5))
    return {"embed": embed, "layers": layers, "final_norm": ones(D),
            "lm_head": dense((D, cfg.vocab), fan)}


def param_logical_axes(cfg: Config = LLAMA3_8B) -> dict:
    """Each leaf's dims by logical name, the tree of ``init`` (an MoE
    model's expert FFN under ``layers["moe"]``)."""
    layers = {
        "attn_norm": (LAYER, None),
        "wq": (LAYER, EMBED, HEAD),
        "wk": (LAYER, EMBED, KV_HEAD),
        "wv": (LAYER, EMBED, KV_HEAD),
        "wo": (LAYER, HEAD, EMBED),
        "mlp_norm": (LAYER, None),
    }
    if cfg.n_experts:
        layers["moe"] = moelib.param_logical_axes(stacked=True)
    else:
        layers.update(w_gate=(LAYER, EMBED, MLP), w_up=(LAYER, EMBED, MLP),
                      w_down=(LAYER, MLP, EMBED))
    return {
        "embed": (VOCAB, EMBED),
        "layers": layers,
        "final_norm": (None,),
        "lm_head": (EMBED, VOCAB),
    }


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s weights from the stacked [L, ...] tree, nested
    subtrees (``moe``) included."""
    return {name: layer_params(w, i) if isinstance(w, dict) else w[i]
            for name, w in layers.items()}


AttentionFn = Callable[..., Any]  # (q, k, v, causal=...) -> out


def _ffn(h, layer, cfg: Config, ctx: moelib.MeshContext | None = None):
    """The FFN half of a block on the pre-normed activations; returns
    (out, aux), aux the f32 [load_balance_loss, dropped_fraction] vector
    (zeros for the dense FFN). ``ctx`` places an MoE FFN under a mesh."""
    if cfg.n_experts:
        # One rank's call keeps moe.apply's own signature (a wrapper of it
        # that predates ``ctx`` still sees the same call).
        kw = {} if ctx is None else {"ctx": ctx}
        return moelib.apply(layer["moe"], h, cfg.moe, with_stats=True, **kw)
    gated = F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])
    return gated @ layer["w_down"], torch.zeros(2, dtype=torch.float32, device=h.device)


def check_tensor_parallel(cfg: Config, n: int) -> None:
    """Refuse a ``model`` axis of ``n`` that does not divide a dim the TP
    rules split over it (the JAX package's device_put of the leaves
    refuses an uneven split too). Dividing the query heads is not needed:
    a head may straddle two ranks (``_layer``)."""
    for what, size in (("n_heads x head_dim", cfg.q_dim),
                       ("n_kv_heads x head_dim", cfg.kv_dim),
                       ("mlp_dim", cfg.mlp_dim), ("vocab", cfg.vocab)):
        if size % n:
            raise ValueError(f"a model axis of {n} does not divide {what} ({size}): the "
                             "tensor-parallel rules split it evenly over the axis")


def head_range(cfg: Config, n: int, index: int) -> tuple[int, int, int]:
    """(first, end) of the query heads rank ``index`` of a ``model`` axis of
    ``n`` attends and the offset of its own q columns inside them: its
    contiguous heads where the axis divides them, else every head that
    overlaps its even share of the columns."""
    cols = cfg.q_dim // n
    start = index * cols
    lo, hi = start // cfg.head_dim, -(-(start + cols) // cfg.head_dim)
    return lo, hi, start - lo * cfg.head_dim


def _head_range(cfg: Config, tp) -> tuple[int, int, int]:
    """``head_range`` of this rank of ``tp`` (every head without it)."""
    if tp is None:
        return 0, cfg.n_heads, 0
    return head_range(cfg, tp.size, tp.index)


def _gather_heads(q, tp):
    """Every rank's q columns [B, T, q_dim / n] gathered over ``tp``. The
    backward reduce-scatters: a head that straddles two ranks is attended
    on both, and its columns' gradient is the sum of both ranks' shares."""
    return collectives.all_gather(q, tp, gather_dim=2)


def _kv_heads(h, w, cfg: Config, tp, lo: int, hi: int):
    """K or V [B, T, h_kv, hd] for query heads [lo, hi) from ``w``'s piece:
    this rank's own contiguous KV heads where the axis divides them (all of
    them without ``tp``); else, out of ``w`` gathered over the axis, the
    KV heads of those query heads: whole groups, the one head they share,
    or one head for each."""
    B, T, _ = h.shape
    n = tp.size if tp is not None else 1
    if cfg.n_kv_heads % n == 0:
        return (h @ w).reshape(B, T, cfg.n_kv_heads // n, cfg.head_dim)
    full = (h @ collectives.all_gather(w, tp, gather_dim=w.dim() - 1)).reshape(
        B, T, cfg.n_kv_heads, cfg.head_dim)
    group = cfg.n_heads // cfg.n_kv_heads
    if lo % group == 0 and hi % group == 0:
        return full[:, :, lo // group:hi // group]
    if lo // group == (hi - 1) // group:
        return full[:, :, lo // group:lo // group + 1]
    return full[:, :, torch.arange(lo, hi, device=h.device) // group]


def _enter(x, tp):
    return x if tp is None else collectives.copy_to(x, tp)


def _leave(x, tp):
    return x if tp is None else collectives.reduce_from(x, tp)


def _layer(x, layer, cfg: Config, cos, sin, attn_fn: AttentionFn, tp=None, ctx=None):
    """One block. Under ``tp`` it runs on this rank's slice of the heads
    and the MLP: each half enters through ``copy_to`` and leaves through
    ``reduce_from``, the residual stream replicated. An MoE FFN crosses
    the ``model`` and ``expert`` axes itself (``moe.apply`` under
    ``ctx``): its router is not split over ``model``."""
    B, T, _ = x.shape
    lo, hi, off = _head_range(cfg, tp)
    h = _enter(rmsnorm(x, layer["attn_norm"]), tp)
    q = h @ layer["wq"]
    cols = q.shape[-1]
    if tp is not None and cfg.n_heads % tp.size:
        # A head straddles ranks: attend on the whole heads this rank's
        # columns touch.
        q = _gather_heads(q, tp)[..., lo * cfg.head_dim:hi * cfg.head_dim]
    q = q.reshape(B, T, hi - lo, cfg.head_dim)
    k = _kv_heads(h, layer["wk"], cfg, tp, lo, hi)
    v = _kv_heads(h, layer["wv"], cfg, tp, lo, hi)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, k, v, causal=True).reshape(B, T, (hi - lo) * cfg.head_dim)
    x = x + _leave(attn[..., off:off + cols] @ layer["wo"], tp)
    h = rmsnorm(x, layer["mlp_norm"])
    if cfg.n_experts:
        ffn, aux = _ffn(h, layer, cfg, ctx)
        return x + ffn, aux
    ffn, aux = _ffn(_enter(h, tp), layer, cfg)
    return x + _leave(ffn, tp), aux


def _embed(params, ids, cfg: Config, tp=None):
    """The embedding rows of ``ids`` (a negative id counts from the end of
    the vocabulary, as a JAX gather does). Under ``tp`` each rank looks up
    the ids of its vocabulary slice, zeros the others, and the slices sum."""
    ids = torch.where(ids < 0, ids + cfg.vocab, ids)
    table = params["embed"]
    if tp is None:
        return F.embedding(ids, table).to(cfg.dtype)
    rows = table.shape[0]
    local = ids - tp.index * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), table)
    return collectives.reduce_from(torch.where(mine[..., None], x, 0).to(cfg.dtype), tp)


def _rope(cfg: Config, t: int, positions, device):
    """RoPE's cos/sin at ``positions`` (host ints; default 0..t-1)."""
    if positions is None:
        return rope_frequencies(cfg.head_dim, t, cfg.rope_theta, device=device)
    positions = np.asarray(positions, dtype=np.int64)
    cos, sin = rope_frequencies(cfg.head_dim, int(positions.max()) + 1, cfg.rope_theta,
                                device=device)
    index = torch.from_numpy(positions).to(device)
    return cos[index], sin[index]


def hidden_states(params, tokens, cfg: Config = LLAMA3_8B,
                  attn_fn: AttentionFn | None = None, positions=None, tp=None, ctx=None):
    """tokens [B, T] -> (final-normed hidden [B, T, D], aux vector [2]:
    the summed MoE load-balance loss and per-layer drop fraction).
    ``positions`` [T] (host ints: numpy or a CPU tensor) are the tokens'
    global positions (a sequence shard's; default 0..T-1). A negative
    token id counts from the end of the vocabulary, as a JAX gather does.
    ``tp`` (an ``Axis``): ``params`` hold this rank's tensor-parallel
    slices; the hidden states come out whole on every rank. ``ctx`` (a
    ``moe.MeshContext``) places an MoE FFN under the mesh: aux is then this
    rank's share."""
    check_supported(cfg)
    if tp is not None:
        check_tensor_parallel(cfg, tp.size)
    if attn_fn is None:
        attn_fn = default_attention
    cos, sin = _rope(cfg, tokens.shape[1], positions, tokens.device)
    x = _embed(params, tokens.long(), cfg, tp)
    layers = params["layers"]
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        layer = layer_params(layers, i)
        if cfg.remat:
            x, a = rematlib.checkpoint(_layer, x, layer, cfg, cos, sin, attn_fn, tp, ctx,
                                       policy=cfg.remat_policy)
        else:
            x, a = _layer(x, layer, cfg, cos, sin, attn_fn, tp, ctx)
        aux = aux + a
    return rmsnorm(x, params["final_norm"]), aux


def apply(params, tokens, cfg: Config = LLAMA3_8B,
          attn_fn: AttentionFn | None = None, return_aux: bool = False):
    """tokens: [B, T] int. Returns logits [B, T, vocab] float32."""
    x, aux = hidden_states(params, tokens, cfg, attn_fn)
    logits = (x @ params["lm_head"]).float()
    if return_aux:
        return logits, aux[0]
    return logits


def _z_term(logits, labels, ignore_index, z_loss, denom=None):
    """z_loss * masked mean of logsumexp^2, as reported in stats."""
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels != ignore_index).float()
    count = torch.sum(mask) if denom is None else denom
    return z_loss * (torch.sum(torch.square(logz) * mask) / torch.clamp(count, min=1.0))


def loss_and_stats(params, tokens, cfg: Config = LLAMA3_8B,
                   attn_fn: AttentionFn | None = None, ignore_index: int = -1,
                   labels=None, positions=None, denom=None, tp=None, ctx=None):
    """Next-token CE (plus the weighted MoE aux) over tokens [B, T+1];
    returns (loss, stats). An MoE model reports stats["moe_drop_frac"],
    the mean per-layer share of routing assignments over capacity. With
    cfg.vocab_chunk the CE comes straight from the hidden states.

    A shard of a sharded batch passes its inputs [B, T] as ``tokens`` with
    their ``labels`` [B, T] (shifted before the sequence was cut), their
    global ``positions`` and ``denom``, the count of kept labels over the
    global batch: the loss and the z-loss term are then this shard's
    shares of the global means, which sum over the shards to them.

    Under ``tp`` the params are this rank's tensor-parallel slices and the
    CE is ``vocab_parallel_cross_entropy`` on the local head (chunked by
    ``cfg.vocab_chunk`` within the slice); the loss and stats come out
    equal on every rank of the axis. ``ctx`` as in ``hidden_states``: the
    MoE aux and ``moe_drop_frac`` are then this rank's shares."""
    stats = {}
    if labels is None:
        tokens, labels = tokens[:, :-1], tokens[:, 1:]
    x, aux = hidden_states(params, tokens, cfg, attn_fn, positions, tp, ctx)
    if tp is not None:
        loss = vocab_parallel_cross_entropy(
            x, params["lm_head"], labels, tp, ignore_index, z_loss=cfg.z_loss,
            denom=denom, vocab_chunk=cfg.vocab_chunk, return_z_term=bool(cfg.z_loss))
        if cfg.z_loss:
            loss, stats["z_loss_term"] = loss
    elif cfg.vocab_chunk:
        loss = chunked_softmax_cross_entropy(
            x, params["lm_head"], labels, cfg.vocab_chunk, ignore_index,
            z_loss=cfg.z_loss, return_z_term=bool(cfg.z_loss), denom=denom)
        if cfg.z_loss:
            loss, stats["z_loss_term"] = loss
    else:
        logits = (x @ params["lm_head"]).float()
        loss = softmax_cross_entropy(logits, labels, ignore_index, z_loss=cfg.z_loss,
                                     denom=denom)
        if cfg.z_loss:
            stats["z_loss_term"] = _z_term(logits, labels, ignore_index, cfg.z_loss, denom)
    if cfg.n_experts:
        loss = loss + cfg.moe_aux_weight * aux[0]
        stats["moe_drop_frac"] = aux[1] / cfg.n_layers
    return loss, stats


def loss_fn(params, tokens, cfg: Config = LLAMA3_8B,
            attn_fn: AttentionFn | None = None, ignore_index: int = -1):
    """Next-token cross entropy over tokens [B, T+1]."""
    return loss_and_stats(params, tokens, cfg, attn_fn, ignore_index)[0]


# ------------------------------------------------- pipelined losses ----


def _stage_fn(cfg: Config, chunks: list, n: int, cos, sin, attn_fn: AttentionFn | None):
    """The pipeline stage body: chunk c's ``n`` layers (``chunks[c]``, a
    stacked layer tree) on h; returns (h, aux), aux the summed MoE [load_balance,
    dropped] vector (None for a dense model). GPipe and 1F1B run the same
    function. Remat recomputes each layer in the backward; a forward with
    no graph (1F1B's, an eval's) runs the layers plainly."""
    attn_fn = attn_fn if attn_fn is not None else default_attention

    def fn(h, c):
        layers = chunks[c]
        aux = torch.zeros(2, dtype=torch.float32, device=h.device)
        for i in range(n):
            layer = layer_params(layers, i)
            if cfg.remat and torch.is_grad_enabled():
                h, a = rematlib.checkpoint(_layer, h, layer, cfg, cos, sin, attn_fn,
                                           policy=cfg.remat_policy)
            else:
                h, a = _layer(h, layer, cfg, cos, sin, attn_fn)
            aux = aux + a
        return h, (aux if cfg.n_experts else None)

    return fn


# What this rank held of the embedding's output and its cotangent through
# the latest pipelined call (``_PipeEmbedding``), in bytes: the most
# microbatch outputs at once ("x"), the most microbatch cotangents at once
# ("d_x"), and the cotangent rows kept for the table's gradient ("d_rows").
PIPE_HELD = {"x": 0, "d_x": 0, "d_rows": 0}


class _PipeEmbedding:
    """The vocab-parallel embedding over ``pipe`` as the pipeline's feed
    (``parallel.pipeline.Feed``), one microbatch at a time. ``take(j)``
    looks up microbatch j's ids on this rank's rows and sums the slices
    over ``pipe``; only the first rank keeps the sum (global stage 0 reads
    it), until its cotangent comes back. ``give(j, d)`` broadcasts that
    cotangent from the first rank, and each rank keeps the rows of the
    positions whose ids are its own; ``table_grad()`` is autograd's
    embedding backward on those rows, once. So no rank holds the whole
    batch's output or cotangent."""

    def __init__(self, params, ids, cfg: Config, pipe, m: int, grad: bool):
        self.params, self.cfg, self.pipe, self.grad = params, cfg, pipe, grad
        self.ids, self.n = ids.chunk(m), m
        b, t = self.ids[0].shape
        self.like = torch.zeros((), dtype=cfg.dtype, device=ids.device).expand(b, t, cfg.dim)
        self.nbytes = self.like.numel() * self.like.element_size()
        self.held = dict.fromkeys(PIPE_HELD, 0)
        PIPE_HELD.update(self.held)
        if grad:
            rows = params["embed"].shape[0]
            local = (torch.where(ids < 0, ids + cfg.vocab, ids) - pipe.index * rows).reshape(m, -1)
            self.sel = [torch.nonzero((r >= 0) & (r < rows)).squeeze(1) for r in local]
            self.local = torch.cat([r[s] for r, s in zip(local, self.sel)])
            self.starts = np.cumsum([0] + [len(s) for s in self.sel]).tolist()
            self.d_rows = None

    def _hold(self, what: str, nbytes: int) -> None:
        self.held[what] += nbytes
        PIPE_HELD[what] = max(PIPE_HELD[what], self.held[what])

    def take(self, j: int):
        with torch.no_grad():
            x = _embed(self.params, self.ids[j], self.cfg, self.pipe)
        self._hold("x", self.nbytes)
        if not (self.grad and self.pipe.index == 0):
            self._hold("x", -self.nbytes)  # dropped, or read once by an eval's stage
        return x if self.pipe.index == 0 else None

    def give(self, j: int, d) -> None:
        from oim_tpu_torch.parallel.pipeline import broadcast_from

        own = 0 if d is None else self.nbytes
        self._hold("d_x", own)
        d = broadcast_from(d, self.pipe, 0, self.like)
        self._hold("d_x", self.nbytes)
        if self.d_rows is None:
            self.d_rows = d.new_empty(len(self.local), d.shape[-1])
            self._hold("d_rows", self.d_rows.numel() * self.d_rows.element_size())
        a, b = self.starts[j], self.starts[j + 1]
        torch.index_select(d.reshape(-1, d.shape[-1]), 0, self.sel[j], out=self.d_rows[a:b])
        del d
        self._hold("d_x", -own - self.nbytes)
        if self.pipe.index == 0:
            self._hold("x", -self.nbytes)  # stage 0 dropped microbatch j's input

    def table_grad(self) -> torch.Tensor:
        table = self.params["embed"]
        return torch.ops.aten.embedding_dense_backward(
            self.d_rows.to(table.dtype), self.local, table.shape[0], -1, False)


def _pipelined(cfg: Config, pipe, n_microbatches: int, attn_fn, ignore_index: int,
               shards: int, n_virtual: int | None):
    """The pipelined loss over the ``pipe`` axis: GPipe where ``n_virtual``
    is None, else 1F1B with that many chunks a rank."""
    from oim_tpu_torch.parallel import pipeline, pipeline_1f1b
    from oim_tpu_torch.train.state import tree_leaves, tree_unflatten

    m = n_microbatches

    def run(params, inputs, labels, positions=None, denom=None, grad=True):
        check_supported(cfg)
        b, t = inputs.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        if denom is None:
            denom = (labels != ignore_index).sum().float()
        cos, sin = _rope(cfg, t, positions, inputs.device)
        feed = _PipeEmbedding(params, inputs.long(), cfg, pipe, m, grad)
        targets = labels.chunk(m)
        weights = [1.0 / torch.clamp(denom, min=1.0)] * m
        head_params = [params["final_norm"], params["lm_head"]]

        def head_fn(h, j):
            out = vocab_parallel_cross_entropy(
                rmsnorm(h, head_params[0]), head_params[1], targets[j], pipe, ignore_index,
                reduction="sum", z_loss=cfg.z_loss, vocab_chunk=cfg.vocab_chunk,
                return_z_term=bool(cfg.z_loss))
            return out if cfg.z_loss else (out, None)

        leaves = list(tree_leaves(params["layers"]))
        interleaved = n_virtual is not None and n_virtual > 1 and grad
        chunk_leaves = (pipeline_1f1b.to_schedule_layout(leaves, pipe, n_virtual, cfg.n_layers)
                        if interleaved else [leaves])
        stage = _stage_fn(cfg, [tree_unflatten(params["layers"], ls) for ls in chunk_leaves],
                          chunk_leaves[0][0].shape[0], cos, sin, attn_fn)
        aux_seed = None
        if cfg.n_experts:
            aux_seed = torch.tensor([cfg.moe_aux_weight / (m * shards), 0.0],
                                    device=inputs.device)
        if n_virtual is not None and grad:
            res = pipeline_1f1b.pipeline_1f1b_value_and_grad(
                stage, head_fn, chunk_leaves, head_params, feed, weights, pipe, aux_seed)
        else:
            res = pipeline.pipeline_value_and_grad(
                stage, head_fn, leaves, head_params, feed, weights, pipe, aux_seed, grad)
        loss, stats = res.loss, {}
        if cfg.z_loss and n_virtual is None:
            stats["z_loss_term"] = res.extra
        if cfg.n_experts:
            aux = collectives._psum(res.aux, pipe) / (m * shards)
            loss = loss + cfg.moe_aux_weight * aux[0]
            stats["moe_drop_frac"] = aux[1] / cfg.n_layers
        if not grad:
            return loss, None, stats
        d_layers = (pipeline_1f1b.from_schedule_layout(res.d_stage, pipe, cfg.n_layers)
                    if interleaved else res.d_stage[0])
        grads = {"embed": feed.table_grad(), "layers": tree_unflatten(params["layers"], d_layers),
                 "final_norm": res.d_head[0], "lm_head": res.d_head[1]}
        return loss, grads, stats

    return run


def make_pipelined_loss(cfg: Config, pipe, n_microbatches: int,
                        attn_fn: AttentionFn | None = None, ignore_index: int = -1,
                        shards: int = 1):
    """Next-token CE with the stacked layers pipelined over ``pipe`` (an
    ``Axis``) as a GPipe schedule (``parallel/pipeline.py``): returns
    ``fn(params, inputs, labels, positions=None, denom=None, grad=True)
    -> (loss, grads, stats)`` (grads None with ``grad=False``, the eval
    forward).

    ``params`` are this rank's pieces under PIPE_RULES: its L/P layers,
    its vocab slice of ``embed`` (rows) and ``lm_head`` (columns), the
    whole ``final_norm``. The embedding is vocab-parallel over ``pipe``
    (looked up on the local rows and summed); the batch [B, T] (this
    rank's rows and, under sequence parallelism, its positions and
    ``attn_fn`` over the ``seq`` axis) is cut into ``n_microbatches``; the
    head is final norm + the vocab-parallel CE over ``pipe`` with the
    z-loss, each microbatch's sum weighted by 1/``denom`` (the global
    count of kept labels: the loss is the global masked mean, however the
    mask falls across microbatches and ranks). The grads are those of this
    rank's pieces, before any sum over the batch or sequence axes.

    MoE: capacity and routing are per microbatch and per rank's tokens (the
    JAX package routes inside its shard_map); the load-balance aux of each
    real (stage, microbatch) pair joins the loss at
    moe_aux_weight / (M * ``shards``), ``shards`` the ranks that split the
    tokens, and stats["moe_drop_frac"] is this rank's share of the mean
    per-layer drop share. stats["z_loss_term"] is reported with z_loss."""
    return _pipelined(cfg, pipe, n_microbatches, attn_fn, ignore_index, shards, None)


def make_1f1b_loss(cfg: Config, pipe, n_microbatches: int,
                   attn_fn: AttentionFn | None = None, ignore_index: int = -1,
                   shards: int = 1, n_virtual: int = 1):
    """``make_pipelined_loss``'s function under the 1F1B schedule
    (``parallel/pipeline_1f1b.py``): live activations bounded by the pipe
    depth, the stage forward recomputed in its backward. ``n_virtual`` > 1
    is the interleaved schedule: the layers (held canonically, L/P
    contiguous a rank) are exchanged into the schedule's layout each call
    and their gradients back. Requires n_microbatches % pipe == 0 and
    n_layers % (pipe * n_virtual) == 0. As in the JAX package, the z-loss
    is in the loss but stats carry no z_loss_term."""
    return _pipelined(cfg, pipe, n_microbatches, attn_fn, ignore_index, shards,
                      max(1, n_virtual))


def _param_counts(cfg: Config, experts: int) -> int:
    L, D = cfg.n_layers, cfg.dim
    if cfg.n_experts:
        # The router sees every expert; expert weights count ``experts``.
        ffn = D * cfg.n_experts + 3 * experts * D * cfg.mlp_dim
    else:
        ffn = 3 * D * cfg.mlp_dim
    per_layer = 2 * D + D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D + ffn
    return cfg.vocab * D + L * per_layer + D + D * cfg.vocab


def num_params(cfg: Config = LLAMA3_8B) -> int:
    """Total parameters (every expert: the memory number)."""
    return _param_counts(cfg, cfg.n_experts)


def num_active_params(cfg: Config = LLAMA3_8B) -> int:
    """Parameters a token touches (top_k experts: the FLOPs number)."""
    return _param_counts(cfg, min(cfg.moe_top_k, cfg.n_experts))


def num_flops_per_token(cfg: Config = LLAMA3_8B, seq_len: int | None = None) -> float:
    """Training FLOPs/token: 6 x the ACTIVE params plus the attention
    quadratic term (per layer, per token, 2*T*q_dim for QK^T and 2*T*q_dim
    for PV forward; x3 for forward and backward)."""
    flops = 6.0 * num_active_params(cfg)
    if seq_len:
        flops += 4.0 * seq_len * cfg.q_dim * 3 * cfg.n_layers
    return flops


# ------------------------------------------------ weight carry-across ----


def from_numpy(tree, device="cuda", dtype=None) -> dict:
    """The JAX param tree as numpy arrays -> the port's tree, same keys.

    bf16 leaves may arrive as ml_dtypes bfloat16 arrays or as ``uint16``
    views of their bits; both become torch.bfloat16. ``dtype`` casts every
    leaf (None keeps each leaf's own dtype)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree, copy=True, order="C")  # the port's own buffer
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def to_numpy(tree) -> dict:
    """The port's tree -> numpy arrays, same keys; bf16 leaves come out as
    ``uint16`` views of their bits."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
