"""Llama-family decoder-only transformer (``oim_tpu/models/llama.py``),
dense path: RMSNorm / RoPE / SwiGLU / GQA.

The param tree keeps the JAX package's layout, so weights carry across
unchanged: layer weights are STACKED along a leading [L, ...] axis and
``hidden_states`` loops over the layer index (the JAX package scans). The
default attention is ``ops.attention.attention``: the Hopper flash kernels
on CUDA, their plain versions on the CPU. bf16 params and activations;
logits, softmax statistics and loss in f32.

Mixture-of-Experts, rematerialization, the pipelined losses and sequence
parallelism are not ported yet: ``Config`` keeps their fields so configs
compare field for field, and ``check_supported`` refuses a config that
sets one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from oim_tpu_torch.ops.attention import attention as default_attention
from oim_tpu_torch.ops.losses import chunked_softmax_cross_entropy, softmax_cross_entropy
from oim_tpu_torch.ops.norms import rmsnorm
from oim_tpu_torch.ops.rope import apply_rope, rope_frequencies


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
    # Not ported yet (check_supported refuses non-defaults): MoE FFN,
    # rematerialization.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "gather"
    remat: bool = False
    remat_policy: str = ""
    # vocab_chunk > 0: the training loss never materializes [B, T, vocab].
    vocab_chunk: int = 0
    # z_loss > 0 adds z_loss * mean(logsumexp^2) to the CE.
    z_loss: float = 0.0

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
    """Refuse what the port does not run yet, instead of ignoring it."""
    if cfg.n_experts:
        raise NotImplementedError("MoE (n_experts > 0) is not ported yet")
    if cfg.remat or cfg.remat_policy:
        raise NotImplementedError("remat is not ported yet")


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
    return {
        "embed": dense((cfg.vocab, D), 0.02),
        "layers": {
            "attn_norm": ones(L, D),
            "wq": dense((L, D, cfg.q_dim), fan),
            "wk": dense((L, D, cfg.kv_dim), fan),
            "wv": dense((L, D, cfg.kv_dim), fan),
            "wo": dense((L, cfg.q_dim, D), cfg.q_dim ** -0.5),
            "mlp_norm": ones(L, D),
            "w_gate": dense((L, D, cfg.mlp_dim), fan),
            "w_up": dense((L, D, cfg.mlp_dim), fan),
            "w_down": dense((L, cfg.mlp_dim, D), cfg.mlp_dim ** -0.5),
        },
        "final_norm": ones(D),
        "lm_head": dense((D, cfg.vocab), fan),
    }


AttentionFn = Callable[..., Any]  # (q, k, v, causal=...) -> out


def _ffn(h, layer, cfg: Config):
    """Dense SwiGLU FFN on the pre-normed activations; returns (out, aux)
    with aux the zero [load_balance_loss, dropped_fraction] vector of a
    dense layer."""
    gated = F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])
    return gated @ layer["w_down"], torch.zeros(2, dtype=torch.float32, device=h.device)


def _layer(x, layer, cfg: Config, cos, sin, attn_fn: AttentionFn):
    B, T, _ = x.shape
    h = rmsnorm(x, layer["attn_norm"])
    q = (h @ layer["wq"]).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = (h @ layer["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ layer["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, k, v, causal=True)
    x = x + attn.reshape(B, T, cfg.q_dim) @ layer["wo"]
    h = rmsnorm(x, layer["mlp_norm"])
    ffn, aux = _ffn(h, layer, cfg)
    return x + ffn, aux


def hidden_states(params, tokens, cfg: Config = LLAMA3_8B,
                  attn_fn: AttentionFn | None = None):
    """tokens [B, T] -> (final-normed hidden [B, T, D], aux vector [2])."""
    check_supported(cfg)
    if attn_fn is None:
        attn_fn = default_attention
    T = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, T, cfg.rope_theta, device=tokens.device)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    layers = params["layers"]
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _layer(x, {name: w[i] for name, w in layers.items()}, cfg,
                      cos, sin, attn_fn)
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


def _z_term(logits, labels, ignore_index, z_loss):
    """z_loss * masked mean of logsumexp^2, as reported in stats."""
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels != ignore_index).float()
    return z_loss * (torch.sum(torch.square(logz) * mask)
                     / torch.clamp(torch.sum(mask), min=1.0))


def loss_and_stats(params, tokens, cfg: Config = LLAMA3_8B,
                   attn_fn: AttentionFn | None = None, ignore_index: int = -1):
    """Next-token CE over tokens [B, T+1]; returns (loss, stats). With
    cfg.vocab_chunk the CE comes straight from the hidden states."""
    stats = {}
    x, _ = hidden_states(params, tokens[:, :-1], cfg, attn_fn)
    labels = tokens[:, 1:]
    if cfg.vocab_chunk:
        loss = chunked_softmax_cross_entropy(
            x, params["lm_head"], labels, cfg.vocab_chunk, ignore_index,
            z_loss=cfg.z_loss, return_z_term=bool(cfg.z_loss))
        if cfg.z_loss:
            loss, stats["z_loss_term"] = loss
    else:
        logits = (x @ params["lm_head"]).float()
        loss = softmax_cross_entropy(logits, labels, ignore_index, z_loss=cfg.z_loss)
        if cfg.z_loss:
            stats["z_loss_term"] = _z_term(logits, labels, ignore_index, cfg.z_loss)
    return loss, stats


def loss_fn(params, tokens, cfg: Config = LLAMA3_8B,
            attn_fn: AttentionFn | None = None, ignore_index: int = -1):
    """Next-token cross entropy over tokens [B, T+1]."""
    return loss_and_stats(params, tokens, cfg, attn_fn, ignore_index)[0]


def num_params(cfg: Config = LLAMA3_8B) -> int:
    """Total parameters (dense FFN)."""
    L, D = cfg.n_layers, cfg.dim
    per_layer = (2 * D + D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D
                 + 3 * D * cfg.mlp_dim)
    return cfg.vocab * D + L * per_layer + D + D * cfg.vocab


def num_flops_per_token(cfg: Config = LLAMA3_8B, seq_len: int | None = None) -> float:
    """Training FLOPs/token: 6*N plus the attention quadratic term (per
    layer, per token, 2*T*q_dim for QK^T and 2*T*q_dim for PV forward;
    x3 for forward and backward)."""
    flops = 6.0 * num_params(cfg)
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
