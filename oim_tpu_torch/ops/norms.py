"""Normalization ops (``oim_tpu/ops/norms.py``): plain torch, reduced in
float32 whatever the activation dtype, cast back."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-family). weight shape: x.shape[-1]."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
