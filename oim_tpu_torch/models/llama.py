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
the global count of kept labels. The pipelined losses are not ported yet.

Tensor parallelism (``tp``, the ``model`` mesh axis; Megatron's split, as
``TP_SP_RULES`` lays the leaves out): each rank holds a contiguous slice
of the query and KV heads (wq/wk/wv by column, wo by row), of the MLP
(w_gate/w_up by column, w_down by row) and of the vocabulary (embed's
rows, lm_head's columns). A layer enters each half through
``copy_to`` and leaves it through ``reduce_from`` after wo and w_down; the
embedding is looked up on the local rows and summed the same way, and the
loss is ``vocab_parallel_cross_entropy`` on the local head. Where the
axis divides the query heads but not the KV heads (llama-tiny's 4/2 at
4), wk/wv are gathered over the axis and each rank takes the KV head of
each of its query heads. An MoE FFN takes the mesh context
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
    """Refuse a ``model`` axis of ``n`` the port's TP layer cannot split:
    ``n`` not dividing the query heads (the JAX package then lets XLA
    split inside a head)."""
    if cfg.n_heads % n:
        raise NotImplementedError(
            f"a model axis of {n} that does not divide n_heads ({cfg.n_heads}): the port "
            "splits whole query heads")


def _kv_heads(h, w, cfg: Config, tp):
    """This rank's K or V heads [B, T, h_kv, hd] from ``w``'s piece: its
    own contiguous KV heads where the axis divides them (all of them
    without ``tp``), else the KV head of each of its query heads out of
    ``w`` gathered over the axis."""
    B, T, _ = h.shape
    n = tp.size if tp is not None else 1
    if cfg.n_kv_heads % n == 0:
        return (h @ w).reshape(B, T, cfg.n_kv_heads // n, cfg.head_dim)
    full = (h @ collectives.all_gather(w, tp, gather_dim=w.dim() - 1)).reshape(
        B, T, cfg.n_kv_heads, cfg.head_dim)
    h_local = cfg.n_heads // n
    group = cfg.n_heads // cfg.n_kv_heads
    index = (torch.arange(h_local, device=h.device) + tp.index * h_local) // group
    return full[:, :, index]


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
    h_local = cfg.n_heads // (tp.size if tp is not None else 1)
    h = _enter(rmsnorm(x, layer["attn_norm"]), tp)
    q = (h @ layer["wq"]).reshape(B, T, h_local, cfg.head_dim)
    k = _kv_heads(h, layer["wk"], cfg, tp)
    v = _kv_heads(h, layer["wv"], cfg, tp)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, k, v, causal=True)
    x = x + _leave(attn.reshape(B, T, h_local * cfg.head_dim) @ layer["wo"], tp)
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
    T = tokens.shape[1]
    if positions is None:
        cos, sin = rope_frequencies(cfg.head_dim, T, cfg.rope_theta, device=tokens.device)
    else:
        positions = np.asarray(positions, dtype=np.int64)
        cos, sin = rope_frequencies(cfg.head_dim, int(positions.max()) + 1, cfg.rope_theta,
                                    device=tokens.device)
        index = torch.from_numpy(positions).to(tokens.device)
        cos, sin = cos[index], sin[index]
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
