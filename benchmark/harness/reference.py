"""The plain reference: the published architecture (Mistral's and
Mixtral's decoder: RMSNorm, split-half RoPE, grouped-query causal
attention, SwiGLU or a top-k expert SwiGLU) in float32 PyTorch, with no
kernel, cache or batching of the program. It imports nothing of the
program and takes from the harness only the weights and tokens the
harness made.

TF32 is switched off: a float32 product on the card would otherwise run
in a lower precision. ``quant="fp8"`` is the control: the same model with
every weight, every activation entering a projection and the K/V rounded
to float8 e4m3 (per output column, per row and per head-row scales, as
an fp8 deployment scales them), products accumulated in float32.

Departures, each stated in the configuration's file: the program's
RMSNorm epsilon is fixed at 1e-6 and the reference uses it; the MoE layer
follows the GShard capacity rule the configuration assumes (tokens over
an expert's capacity are dropped, kept gates renormalised), with
Switch's top-1 load-balance loss, as the program computes it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.harness.model import Dims

FP8_MAX = 448.0
Q_CHUNK = 1024  # query rows of the attention scores held at once


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its absolute maximum maps to 448), returned in float32; the gradient
    passes the rounding unchanged (straight through), as fp8 training's
    does."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        scale = amax / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _proj(x, w, quant):
    if quant == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, 0)
    return x @ w


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope_tables(d: Dims, positions: torch.Tensor):
    half = d.head_dim // 2
    exps = torch.arange(0, d.head_dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (d.rope_theta ** (exps / d.head_dim))
    ang = positions.float()[:, None] * inv[None, :half]
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin):
    """x [..., T, H, hd]: the pairs (x[:hd/2], x[hd/2:]) rotated."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def causal_attention(q, k, v):
    """q [B, T, H, hd], k/v [B, T, Hkv, hd] -> [B, T, H, hd], float32,
    query rows in chunks so that the scores of a long sequence fit."""
    B, T, H, hd = q.shape
    g = H // k.shape[2]
    kk = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)  # [B, H, hd, T]
    vv = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)  # [B, H, T, hd]
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for a in range(0, T, Q_CHUNK):
        b = min(a + Q_CHUNK, T)
        qc = q[:, a:b].permute(0, 2, 1, 3)  # [B, H, c, hd]
        s = (qc @ kk[..., :b]) * hd ** -0.5
        mask = keys[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[:, a:b] = (torch.softmax(s, dim=-1) @ vv[:, :, :b]).permute(0, 2, 1, 3)
    return out


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


def layer_weights(params: dict, i: int, device=None) -> dict:
    """Layer ``i``'s weights from the stacked tree, as float32 copies."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i].to(device=device, dtype=torch.float32)
    return pick(params["layers"])


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


def served_gaps(ref_logits, served) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at that position (0 where the two agree)."""
    served = torch.as_tensor(served, device=ref_logits.device, dtype=torch.long)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, served[:, None])[:, 0]
