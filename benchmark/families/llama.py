"""The Llama family: Mistral's and Mixtral's decoder (RMSNorm, split-half
RoPE, grouped-query causal attention, SwiGLU or a top-k expert SwiGLU),
as the port's ``models/llama.py`` runs it.

What the harness needs of one architecture, found by the configuration's
``"family"``: its sizes (``dims``), its weights in the port's param tree
(``make_params``, ``count_params``), the program's configs
(``serve_config``, ``train_config``), the plain reference (``logits_at``,
``loss``) and the counts of operations and bytes.

Sizes: the configuration file keeps the published ``config.json``'s keys
and values, changed only where ``reduced`` says; ``run`` holds what the
published file does not state and the run needs (the serving dtype, the
capacity factor, the loss's vocabulary chunk), each listed under
``assumed`` too.

Weights: stacked [L, ...] layer leaves, an MoE model's under
``layers["moe"]``, in one flat draw (``weights.draw``) at the port's init
scales: 0.02 for the embedding, fan-in for the projections; the MoE
router is one float32 draw, the norm weights ones.

Reference, in float32 PyTorch with no kernel, cache or batching of the
program; it imports nothing of the program. Departures, each stated in
the configuration's file: the program's RMSNorm epsilon is fixed at 1e-6
and the reference uses it; the MoE layer follows the GShard capacity rule
the configuration assumes (tokens over an expert's capacity are dropped,
kept gates renormalised), with Switch's top-1 load-balance loss, as the
program computes it.

Counts: attention counts the kept causal pairs (q at position i sees
keys 0..i); bytes count each input read once and each output written
once (``harness/flops.py``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from benchmark.harness import weights
from benchmark.harness.flops import BF16, F32, causal_pairs
from benchmark.harness.reference import (_proj, causal_attention, fp8_round, layer_weights,
                                         rmsnorm, rope)


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    mlp_dim: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0
    aux_weight: float = 0.0
    capacity_factor: float = 0.0
    vocab_chunk: int = 0
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def dims(conf: dict) -> Dims:
    """The sizes of a configuration file."""
    run = conf.get("run", {})
    heads = conf["num_attention_heads"]
    return Dims(
        name=conf["name"],
        vocab=conf["vocab_size"],
        dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
        mlp_dim=conf["intermediate_size"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        n_experts=conf.get("num_local_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0),
        aux_weight=float(conf.get("router_aux_loss_coef", 0.0)),
        capacity_factor=float(run.get("moe_capacity_factor", 0.0)),
        vocab_chunk=int(run.get("vocab_chunk", 0)),
        dtype=run.get("dtype", conf.get("torch_dtype", "bfloat16")),
    )


# -- weights -------------------------------------------------------------------

def leaf_shapes(d: Dims) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, scale) of each model-dtype leaf, in draw order."""
    L, D = d.n_layers, d.dim
    leaves = [
        (("embed",), (d.vocab, D), 0.02),
        (("layers", "wq"), (L, D, d.q_dim), D ** -0.5),
        (("layers", "wk"), (L, D, d.kv_dim), D ** -0.5),
        (("layers", "wv"), (L, D, d.kv_dim), D ** -0.5),
        (("layers", "wo"), (L, d.q_dim, D), d.q_dim ** -0.5),
    ]
    if d.n_experts:
        E = d.n_experts
        leaves += [
            (("layers", "moe", "w_gate"), (L, E, D, d.mlp_dim), D ** -0.5),
            (("layers", "moe", "w_up"), (L, E, D, d.mlp_dim), D ** -0.5),
            (("layers", "moe", "w_down"), (L, E, d.mlp_dim, D), d.mlp_dim ** -0.5),
        ]
    else:
        leaves += [
            (("layers", "w_gate"), (L, D, d.mlp_dim), D ** -0.5),
            (("layers", "w_up"), (L, D, d.mlp_dim), D ** -0.5),
            (("layers", "w_down"), (L, d.mlp_dim, D), d.mlp_dim ** -0.5),
        ]
    leaves.append((("lm_head",), (D, d.vocab), D ** -0.5))
    return leaves


def make_params(d: Dims, seed: int, device) -> dict:
    """The param tree of ``d`` drawn from ``seed`` on ``device``."""
    L, D = d.n_layers, d.dim
    ones = [(("layers", "attn_norm"), (L, D)), (("layers", "mlp_norm"), (L, D)),
            (("final_norm",), (D,))]
    routers = ([(("layers", "moe", "router"), (L, D, d.n_experts), D ** -0.5)]
               if d.n_experts else [])
    return weights.draw(leaf_shapes(d), ones, routers, d.dtype, seed, device)


def count_params(d: Dims, active: bool = False) -> int:
    """Parameters of ``d`` (``active``: a token's top-k experts only)."""
    L, D = d.n_layers, d.dim
    attn = D * d.q_dim + 2 * D * d.kv_dim + d.q_dim * D + 2 * D
    experts = (d.top_k if active else d.n_experts) if d.n_experts else 1
    ffn = 3 * experts * D * d.mlp_dim + (D * d.n_experts if d.n_experts else 0)
    return 2 * d.vocab * D + L * (attn + ffn) + D


# -- the program's configs -------------------------------------------------------

def serve_config(d: Dims, mix: dict, dtype):
    """The ``llama.Config`` that ``ServeEngine`` is given."""
    from oim_tpu_torch.models import llama

    return llama.Config(vocab=d.vocab, dim=d.dim, n_layers=d.n_layers, n_heads=d.n_heads,
                        n_kv_heads=d.n_kv_heads, head_dim=d.head_dim, mlp_dim=d.mlp_dim,
                        max_seq=mix["engine"]["max_seq"], rope_theta=d.rope_theta,
                        dtype=dtype, n_experts=d.n_experts, moe_top_k=d.top_k or 2)


def train_config(d: Dims, mix: dict):
    """The ``TrainConfig`` of the training cell's ``Trainer``."""
    from oim_tpu_torch.train import TrainConfig

    opt = mix["optimizer"]
    over = {"vocab": d.vocab, "dim": d.dim, "n_layers": d.n_layers, "n_heads": d.n_heads,
            "n_kv_heads": d.n_kv_heads, "head_dim": d.head_dim, "mlp_dim": d.mlp_dim,
            "max_seq": mix["seq"], "rope_theta": d.rope_theta, "dtype": weights.DTYPES[d.dtype],
            "n_experts": d.n_experts, "moe_top_k": d.top_k or 2,
            "moe_capacity_factor": d.capacity_factor or 1.25,
            "moe_aux_weight": d.aux_weight, "vocab_chunk": d.vocab_chunk}
    return TrainConfig(model="llama3-8b", model_overrides=over, batch_size=mix["batch"],
                       seq_len=mix["seq"], lr=opt["lr"], warmup_steps=opt["warmup_steps"],
                       total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
                       log_every=mix.get("log_every", 10), seed=0)


# -- the plain reference -----------------------------------------------------------

def rope_tables(d: Dims, positions: torch.Tensor):
    half = d.head_dim // 2
    exps = torch.arange(0, d.head_dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (d.rope_theta ** (exps / d.head_dim))
    ang = positions.float()[:, None] * inv[None, :half]
    return torch.cos(ang), torch.sin(ang)


def moe_ffn(h, w, d: Dims, quant=None):
    """The top-k expert SwiGLU over h [N, D] under the GShard capacity
    rule: round r takes each token's r-th best expert by router
    probability; a token's slot is its rank in (round, token) order among
    the tokens sent to that expert, and slots past
    int(top_k * N * capacity_factor / E) are dropped. Kept gates are
    renormalised over the token's kept experts. Returns (out, aux, the
    dropped share)."""
    n = h.shape[0]
    e, k = d.n_experts, d.top_k
    cap = max(1, int(k * n * d.capacity_factor / e))
    probs = torch.softmax(h @ w["router"], dim=-1)
    order = torch.argsort(probs.detach(), dim=-1, descending=True, stable=True)
    fill = torch.zeros(e, dtype=torch.long, device=h.device)
    chosen, kept = [], []
    for r in range(k):
        ex = order[:, r]
        onehot = F.one_hot(ex, e)
        rank = (torch.cumsum(onehot, dim=0) - 1 + fill)[torch.arange(n, device=h.device), ex]
        keep = rank < cap
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        chosen.append(ex)
        kept.append(keep)
    gates = [probs.gather(1, ex[:, None])[:, 0] * keep for ex, keep in zip(chosen, kept)]
    if k > 1:
        denom = torch.clamp(sum(gates), min=1e-9)
        gates = [g / denom for g in gates]
    out = torch.zeros_like(h)
    for ex, keep, g in zip(chosen, kept, gates):
        for j in range(e):
            rows = torch.nonzero((ex == j) & keep).squeeze(1)
            if rows.numel() == 0:
                continue
            x = h[rows]
            f = F.silu(_proj(x, w["w_gate"][j], quant)) * _proj(x, w["w_up"][j], quant)
            y = _proj(f, w["w_down"][j], quant)
            out = out.index_add(0, rows, y * g[rows, None])
    top1 = F.one_hot(order[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(top1 * probs.mean(dim=0))
    dropped = 1.0 - sum(x.float().sum() for x in kept) / (n * k)
    return out, aux, dropped


def layer(x, w, d: Dims, cos, sin, quant=None):
    """One decoder block on x [B, T, D] (float32); returns (x, aux,
    dropped) (aux and dropped 0 for a dense FFN). The router stays in
    float32 under ``quant``, as it does in the program."""
    B, T, D = x.shape
    h = rmsnorm(x, w["attn_norm"], d.norm_eps)
    q = _proj(h, w["wq"], quant).view(B, T, d.n_heads, d.head_dim)
    k = _proj(h, w["wk"], quant).view(B, T, d.n_kv_heads, d.head_dim)
    v = _proj(h, w["wv"], quant).view(B, T, d.n_kv_heads, d.head_dim)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    if quant == "fp8":
        k, v = fp8_round(k, -1), fp8_round(v, -1)
    a = causal_attention(q, k, v).reshape(B, T, d.q_dim)
    x = x + _proj(a, w["wo"], quant)
    h = rmsnorm(x, w["mlp_norm"], d.norm_eps)
    if d.n_experts:
        out, aux, dropped = moe_ffn(h.reshape(B * T, D), w["moe"], d, quant)
        return x + out.view(B, T, D), aux, dropped
    f = F.silu(_proj(h, w["w_gate"], quant)) * _proj(h, w["w_up"], quant)
    zero = x.new_zeros(())
    return x + _proj(f, w["w_down"], quant), zero, zero


@torch.no_grad()
def logits_at(params: dict, d: Dims, tokens, rows, quant=None):
    """Float32 logits [len(rows), vocab] at positions ``rows`` of the
    sequence ``tokens`` [T] (a list or 1-d tensor), run layer by layer
    with each layer's weights upcast on the fly."""
    dev = params["embed"].device
    ids = torch.as_tensor(tokens, device=dev, dtype=torch.long)
    T = ids.shape[0]
    cos, sin = rope_tables(d, torch.arange(T, device=dev))
    x = params["embed"][ids].float()[None]
    for i in range(d.n_layers):
        x, _, _ = layer(x, layer_weights(params, i), d, cos, sin, quant)
    rows = torch.as_tensor(rows, device=dev, dtype=torch.long)
    h = rmsnorm(x[0, rows], params["final_norm"].float(), d.norm_eps)
    return _proj(h, params["lm_head"].float(), quant)


def loss(tree, d: Dims, tokens, quant, ckpt):
    """Mean next-token cross entropy over tokens [B, T+1] plus
    router_aux_loss_coef x the layers' summed load-balance losses, each
    layer recomputed in the backward pass (``ckpt``:
    ``torch.utils.checkpoint``)."""
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    B, T = inputs.shape
    cos, sin = rope_tables(d, torch.arange(T, device=tokens.device))
    x = tree["embed"][inputs]
    aux = x.new_zeros(())
    for i in range(d.n_layers):
        w = {k: (v[i] if not isinstance(v, dict) else {kk: vv[i] for kk, vv in v.items()})
             for k, v in tree["layers"].items()}

        def block(x, w=w):
            y, a, _ = layer(x, w, d, cos, sin, quant)
            return y, a

        x, a = ckpt.checkpoint(block, x, use_reentrant=False)
        aux = aux + a
    h = rmsnorm(x, tree["final_norm"], d.norm_eps).reshape(B * T, -1)
    flat = labels.reshape(-1)
    total = h.new_zeros(())
    for a in range(0, B * T, 4096):
        logits = _proj(h[a:a + 4096], tree["lm_head"], quant)
        total = total + torch.nn.functional.cross_entropy(logits, flat[a:a + 4096],
                                                          reduction="sum")
    return total / (B * T) + d.aux_weight * aux


# -- operations and bytes ------------------------------------------------------------

def matmul_params(d: Dims) -> int:
    """Weights a token multiplies through (top-k experts, the router, the
    head; not the embedding, which is a lookup)."""
    D = d.dim
    attn = D * d.q_dim + 2 * D * d.kv_dim + d.q_dim * D
    if d.n_experts:
        ffn = 3 * d.top_k * D * d.mlp_dim + D * d.n_experts
    else:
        ffn = 3 * D * d.mlp_dim
    return d.n_layers * (attn + ffn) + D * d.vocab


def forward_flops(d: Dims, context: int) -> float:
    """One token's forward FLOPs at a context of ``context`` keys (its
    position + 1): the products with the weights and the attention's QK
    and PV over the context."""
    return 2.0 * matmul_params(d) + 4.0 * d.n_layers * d.q_dim * context


def prompt_flops(d: Dims, n: int) -> float:
    """The forward FLOPs of a whole prompt of ``n`` tokens, causal."""
    return 2.0 * matmul_params(d) * n + 4.0 * d.n_layers * d.q_dim * causal_pairs(n)


def train_flops(d: Dims, batch: int, seq: int) -> float:
    """One training step's model FLOPs: 3 x the forward (forward and
    backward) over ``batch`` rows of ``seq`` tokens, causal."""
    return 3.0 * batch * prompt_flops(d, seq)


def weight_bytes(d: Dims, rows: int) -> int:
    """Bytes of the weights a decode step over ``rows`` rows must read:
    every weight but the embedding (an MoE model's every expert), and the
    embedding's ``rows`` rows."""
    D = d.dim
    attn = D * d.q_dim + 2 * D * d.kv_dim + d.q_dim * D
    experts = max(d.n_experts, 1)
    ffn = 3 * experts * D * d.mlp_dim
    router = D * d.n_experts * F32 if d.n_experts else 0
    norms = (2 * d.n_layers + 1) * D * F32
    return (d.n_layers * ((attn + ffn) * BF16 + router) + D * d.vocab * BF16
            + rows * D * BF16 + norms)


def kv_bytes_per_token(d: Dims) -> int:
    """The K/V bytes one token's key holds over every layer."""
    return 2 * d.n_layers * d.kv_dim * BF16


def decode_step_bytes(d: Dims, contexts) -> int:
    """A decode step's bytes bound over live rows at ``contexts`` (each
    row's keys after this step's token): the weights, each row's K/V read
    once, and the new K/V written."""
    contexts = list(contexts)
    kv_token = kv_bytes_per_token(d)
    return (weight_bytes(d, len(contexts)) + kv_token * sum(contexts)
            + kv_token * len(contexts))


def decode_bytes(d: Dims, steps: int, row_steps: int, kv_tokens: int) -> float:
    """``decode_step_bytes`` summed over ``steps`` decode steps, from the
    engine's sums over them of live rows and of their keys: the weights'
    bytes grow by one embedding row a row, the K/V's by one token's K/V a
    key read and a key written."""
    kv_token = kv_bytes_per_token(d)
    per_row = weight_bytes(d, 1) - weight_bytes(d, 0)
    return (steps * weight_bytes(d, 0) + row_steps * per_row
            + kv_token * (kv_tokens + row_steps))
