"""Rotary position embeddings (``oim_tpu/ops/rope.py``), split-half pairs."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device: torch.device | str = "cuda"):
    """cos/sin tables [max_seq, head_dim//2], float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate [B, T, H, D] by position; positions defaults to arange(T).

    Pair convention: (x[..., :D/2], x[..., D/2:]), matching the tables above.
    """
    if positions is None:
        cos_t, sin_t = cos[: x.shape[1]], sin[: x.shape[1]]
    else:
        cos_t, sin_t = cos[positions], sin[positions]
    # [T, D/2] (or [B, T, D/2]) -> broadcast over heads.
    cos_t, sin_t = cos_t.unsqueeze(-2), sin_t.unsqueeze(-2)
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out1 = xf1 * cos_t - xf2 * sin_t
    out2 = xf2 * cos_t + xf1 * sin_t
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
