"""The plain reference's pieces that any family's reference uses, in
float32 PyTorch with no kernel, cache or batching of the program: the
projection (and its fp8 control), RMSNorm, split-half RoPE, grouped-query
causal attention, a layer's weights from a stacked tree, and the served
tokens' gaps. A family's own reference (``benchmark/families/<family>.py``:
``logits_at``, ``loss``) is built from them. It imports nothing of the
program and takes from the harness only the weights and tokens the
harness made.

TF32 is switched off: a float32 product on the card would otherwise run
in a lower precision. ``quant="fp8"`` is the control: the same model with
every weight, every activation entering a projection and the K/V rounded
to float8 e4m3 (per output column, per row and per head-row scales, as
an fp8 deployment scales them), products accumulated in float32."""

from __future__ import annotations

import torch

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


def layer_weights(params: dict, i: int, device=None) -> dict:
    """Layer ``i``'s weights from the stacked tree, as float32 copies."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i].to(device=device, dtype=torch.float32)
    return pick(params["layers"])


def served_gaps(ref_logits, served) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at that position (0 where the two agree)."""
    served = torch.as_tensor(served, device=ref_logits.device, dtype=torch.long)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, served[:, None])[:, 0]
