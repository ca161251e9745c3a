"""Losses (``oim_tpu/ops/losses.py``).

Cross entropy takes logits in any dtype, reduces in float32, and never
materializes one-hot targets over the full vocabulary.
"""

from __future__ import annotations

import torch


def _masked_mean(v: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int | None) -> torch.Tensor:
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        return torch.sum(v * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(v)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int | None = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross entropy (+ optional z-loss).

    logits: [..., vocab]; labels: [...] int. ``ignore_index`` labels are
    masked out of the mean. ``z_loss`` adds z_loss * mean(logsumexp^2) over
    the same tokens.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # An ignored label (e.g. -1) still needs a valid gather index; its
    # term is masked out of the mean below.
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    label_logits = torch.gather(logits, -1, safe.unsqueeze(-1)).squeeze(-1)
    nll = logz - label_logits
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    return _masked_mean(nll, labels, ignore_index)


def _chunk_bounds(vocab: int, vocab_chunk: int):
    """(start, stop) column ranges; the last chunk is narrower when the
    vocab is not a multiple of the chunk. The JAX package zero-pads
    lm_head to whole chunks and masks the padded columns to -inf; a
    narrower last chunk computes the same sums without copying lm_head."""
    return [(c, min(c + vocab_chunk, vocab)) for c in range(0, vocab, vocab_chunk)]


class _ChunkedNLL(torch.autograd.Function):
    """(nll, logz) per row from hidden states, one vocab chunk at a time.

    The backward recomputes each chunk's logits from the saved (small)
    residuals x, w, m, s: the [N, vocab] logits never exist."""

    @staticmethod
    def forward(ctx, xf, w, yf, vocab_chunk):
        n = xf.shape[0]
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=xf.device)
        s = torch.zeros((n,), dtype=torch.float32, device=xf.device)
        lab = torch.zeros((n,), dtype=torch.float32, device=xf.device)
        for c0, c1 in _chunk_bounds(w.shape[1], vocab_chunk):
            logits = (xf @ w[:, c0:c1]).float()  # [N, C]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            local = yf - c0
            hit = (local >= 0) & (local < c1 - c0)
            picked = torch.gather(
                logits, 1, local.clamp(0, c1 - c0 - 1)[:, None].long())[:, 0]
            lab = torch.where(hit, picked, lab)
        logz = torch.log(s) + m
        ctx.save_for_backward(xf, w, yf, m, s)
        ctx.vocab_chunk = vocab_chunk
        return logz - lab, logz

    @staticmethod
    def backward(ctx, g, gz):
        # d nll/d logits = softmax - onehot, d logz/d logits = softmax: the
        # per-chunk cotangent is p*(g+gz) - onehot*g. dx accumulates in f32
        # (a low-precision accumulator drifts over many chunks).
        xf, w, yf, m, s = ctx.saved_tensors
        gp = g + gz
        dx = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
        dw = torch.empty_like(w)
        for c0, c1 in _chunk_bounds(w.shape[1], ctx.vocab_chunk):
            w_c = w[:, c0:c1]
            logits = (xf @ w_c).float()
            p = torch.exp(logits - m[:, None]) / s[:, None]
            dlogits = p * gp[:, None]
            local = yf - c0
            rows = torch.nonzero((local >= 0) & (local < c1 - c0)).squeeze(-1)
            dlogits[rows, local[rows].long()] -= g[rows]
            dlogits = dlogits.to(xf.dtype)
            dx += (dlogits @ w_c.T).float()
            dw[:, c0:c1] = xf.T @ dlogits
        return dx.to(xf.dtype), dw, None, None


def chunked_softmax_cross_entropy(
    x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
    vocab_chunk: int, ignore_index: int | None = None,
    z_loss: float = 0.0, return_z_term: bool = False,
):
    """CE straight from hidden states, never materializing [N, vocab].

    x: [..., D] final hidden states; lm_head: [D, V]; labels: [...] int.
    Returns the scalar mean CE (and the z-loss term when return_z_term).
    """
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    yf = labels.reshape(-1)
    nll, logz = _ChunkedNLL.apply(xf, lm_head, yf, vocab_chunk)
    z_sq = torch.square(logz)
    if z_loss:
        nll = nll + z_loss * z_sq
    total = _masked_mean(nll, yf, ignore_index)
    if return_z_term:
        return total, z_loss * _masked_mean(z_sq, yf, ignore_index)
    return total
