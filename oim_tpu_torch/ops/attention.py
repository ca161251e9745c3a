"""Attention (``oim_tpu/ops/attention.py``): references, the flash
kernels' plain versions, and the autograd Functions that dispatch to the
Hopper kernels.

Shapes: [batch, seq, heads, head_dim] ("BTHD"). GQA: kv heads may divide
q heads. The causal mask is bottom-right aligned (``q_offset = tk - tq``):
with tq < tk the queries are the LAST tq positions of the key sequence.
``torch.nn.functional.scaled_dot_product_attention(is_causal=True)`` is
top-left aligned and differs whenever tq != tk.

Dispatch: a CUDA tensor goes to the kernels in ``oim_tpu_torch.kernels``
(forward, dKV and dQ); a CPU tensor goes to their plain versions below.
A CUDA call the kernels do not support raises; nothing falls back.

Kernel layouts: out in q's BTHD layout, lse and delta as [B*H, Tq] f32
(the JAX kernels' [B*H, Tq, 1] without the trailing unit axis).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_PLAIN_BLOCK_K = 64


def _expand_gqa(q, k, v):
    """Repeat K/V heads when num_q_heads > num_kv_heads."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq == hkv:
        return k, v
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    rep = hq // hkv
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    """[tq, tk] bool, True where query i (at position tk - tq + i) may see
    key j."""
    q_pos = (tk - tq) + torch.arange(tq, device=device)
    return q_pos[:, None] >= torch.arange(tk, device=device)[None, :]


def ref_attention_lse(q, k, v, causal: bool = True, scale: float | None = None):
    """GQA-native attention returning ``(out f32, lse [B,Tq,H] f32)``."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    group = h // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, tq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        scores = torch.where(_causal_mask(tq, tk, q.device), scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    lse = m + torch.log(l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l[..., None], v.float())
    return out.reshape(b, tq, h, d), lse.permute(0, 3, 1, 2).reshape(b, tq, h)


def mha_reference(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain attention; the numerical ground truth for the kernels."""
    k, v = _expand_gqa(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device),
                             scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


# ------------------------------------------------------- plain versions ----
#
# Each repeats its kernel's arithmetic in torch: f32 scores, NEG_INF mask
# with probabilities re-zeroed, l clamped at 1e-30, the forward's
# probabilities rounded to V's dtype before the PV product, and the
# backward's P and dS rounded to the inputs' dtype before the products
# that take them (dV, dK, dQ), where the tensor-core K2/K3 round them. At
# f32 every such rounding is the identity. They are the CPU path and the
# check the kernels are held against on the card.


def _grouped(q, k, v):
    """q -> [B, Hkv, G, Tq, D], k/v -> [B, Hkv, 1, Tk, D]: GQA through
    broadcasting, K/V never repeated."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    qg = q.reshape(b, tq, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    return qg, k.permute(0, 2, 1, 3).unsqueeze(2), v.permute(0, 2, 1, 3).unsqueeze(2)


def _rows(x, qg):
    """[B*H, Tq] kernel layout -> qg's [B, Hkv, G, Tq] grouped layout."""
    return x.reshape(qg.shape[:-1])


def flash_forward_plain(q, k, v, causal: bool, scale: float):
    """Blockwise online-softmax forward: (out [B,Tq,H,D] in q's dtype,
    lse [B*H, Tq] f32). The plain version of kernel K1."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg, kg, vg = _grouped(q, k, v)
    qg = qg.float()
    shape = qg.shape[:-1]
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    mask = _causal_mask(tq, tk, q.device) if causal else None
    for k0 in range(0, tk, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, tk)
        s = (qg @ kg[..., k0:k1, :].float().transpose(-1, -2)) * scale
        if causal:
            s = torch.where(mask[:, k0:k1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask[:, k0:k1], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        m = m_new
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ vg[..., k0:k1, :].float()
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)  # [B, Hkv, G, Tq, D]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)
    lse = (m + torch.log(l)).reshape(b * h, tq)
    return out, lse


def _operand(x, dtype):
    """x as an operand of a product at ``dtype``'s precision: rounded to
    it and lifted back to f32 (exactly x when dtype is f32)."""
    return x.to(dtype).float()


def _recompute(qg, kg, vg, do, lse, delta, causal, scale):
    """P and dS for the backward: P = exp(s - lse) (masked entries zero),
    dS = P * (dO V^T - delta) * scale, all in f32 (dS from P unrounded)."""
    s = (qg.float() @ kg.float().transpose(-1, -2)) * scale
    p = torch.exp(s - _rows(lse, qg)[..., None])
    if causal:
        p = torch.where(_causal_mask(qg.shape[-2], kg.shape[-2], qg.device), p, 0.0)
    dp = do @ vg.float().transpose(-1, -2)
    ds = p * (dp - _rows(delta, qg)[..., None]) * scale
    return p, ds


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dk, dv) in k's layout and dtype, group-summed over each kv head's
    query heads. The plain version of kernel K2."""
    qg, kg, vg = _grouped(q, k, v)
    dog = _grouped(do, k, v)[0].float()
    p, ds = _recompute(qg, kg, vg, dog, lse, delta, causal, scale)
    p, ds = _operand(p, q.dtype), _operand(ds, q.dtype)
    dv = (p.transpose(-1, -2) @ dog).sum(dim=2)         # [B, Hkv, Tk, D]
    dk = (ds.transpose(-1, -2) @ qg.float()).sum(dim=2)
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dq in q's layout and dtype. The plain version of kernel K3."""
    b, tq, h, d = q.shape
    qg, kg, vg = _grouped(q, k, v)
    dog = _grouped(do, k, v)[0].float()
    _, ds = _recompute(qg, kg, vg, dog, lse, delta, causal, scale)
    dq = _operand(ds, q.dtype) @ kg.float()               # [B, Hkv, G, Tq, D]
    return dq.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d).to(q.dtype)


# ------------------------------------------------------------ dispatch ----


def _forward(q, k, v, causal, scale):
    if q.is_cuda:
        from oim_tpu_torch import kernels

        return kernels.flash_fwd(q, k, v, causal, scale)
    return flash_forward_plain(q, k, v, causal, scale)


def _backward(q, k, v, out, lse, g, causal, scale, g_lse=None):
    """(dq, dk, dv). delta_i = rowsum(dO_i * O_i) is the softmax
    normalization term of dS; when lse is a primal output too, its
    cotangent enters as delta - g_lse (d lse_i / d s_ij = p_ij)."""
    b, tq, h, _ = q.shape
    g = g.contiguous()
    delta = (g.float() * out.float()).sum(-1)               # [B, Tq, H]
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.permute(0, 2, 1).reshape(b * h, tq).contiguous()
    if q.is_cuda:
        from oim_tpu_torch import kernels

        dk, dv = kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
        dq = kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal, scale)
    else:
        dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal, scale)
        dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class _FlashAttentionLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        b, tq, h, _ = q.shape
        return out, lse.reshape(b, h, tq).permute(0, 2, 1)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g_out, ctx.causal,
                               ctx.scale, g_lse=g_lse)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash attention, GQA-native: on CUDA the Hopper kernels (K/V read
    through index arithmetic, never expanded), on the CPU their plain
    versions."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, _scale(q, scale))


def flash_attention_lse(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash attention that also returns the per-row logsumexp [B, Tq, H].
    Both outputs are differentiable: the lse cotangent folds into delta."""
    _check(q, k, v)
    return _FlashAttentionLse.apply(q, k, v, causal, _scale(q, scale))


def _check(q, k, v):
    """The port's dispatch rule: every shape the kernels take goes to
    them on CUDA; anything else raises (on either device, so a CPU test
    sees the same refusals the card would)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want BTHD q/k/v, got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head_dim")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not divisible by kv heads {k.shape[2]}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")
    if q.is_cuda:
        from oim_tpu_torch import kernels

        kernels.check_flash_shapes(q, k, v)


def attention_with_lse(q, k, v, causal: bool = True, scale: float | None = None):
    """Block attention returning ``(out f32, lse [B,Tq,H] f32)``."""
    out, lse = flash_attention_lse(q, k, v, causal, scale)
    return out.float(), lse


def attention(q, k, v, causal: bool = True, scale: float | None = None):
    """The model's attention: flash kernels on CUDA, plain versions on CPU."""
    return flash_attention(q, k, v, causal, scale)
