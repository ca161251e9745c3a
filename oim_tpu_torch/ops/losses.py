"""Losses (``oim_tpu/ops/losses.py``).

Cross entropy takes logits in any dtype, reduces in float32, and never
materializes one-hot targets over the full vocabulary.
``vocab_parallel_cross_entropy`` is the loss of an LM head whose vocab is
split over a mesh axis (tensor parallelism's ``model`` axis, the
pipeline's ``pipe`` axis).
"""

from __future__ import annotations

import torch

from oim_tpu_torch.parallel import collectives


def _masked_mean(v: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int | None, denom=None) -> torch.Tensor:
    """Mean of ``v`` over the kept labels; with ``denom`` (the kept count
    over every shard of a sharded batch), this shard's share of it."""
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        count = torch.sum(mask) if denom is None else denom
        return torch.sum(v * mask) / torch.clamp(count, min=1.0)
    if denom is not None:
        return torch.sum(v) / denom
    return torch.mean(v)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int | None = None,
                          z_loss: float = 0.0, denom=None) -> torch.Tensor:
    """Mean token cross entropy (+ optional z-loss).

    logits: [..., vocab]; labels: [...] int. ``ignore_index`` labels are
    masked out of the mean. ``z_loss`` adds z_loss * mean(logsumexp^2) over
    the same tokens. ``denom`` divides the sum instead of this call's own
    count (a shard's share of a global mean).
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
    return _masked_mean(nll, labels, ignore_index, denom)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean top-1 accuracy as an f32 scalar."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


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
    z_loss: float = 0.0, return_z_term: bool = False, denom=None,
):
    """CE straight from hidden states, never materializing [N, vocab].

    x: [..., D] final hidden states; lm_head: [D, V]; labels: [...] int.
    Returns the scalar mean CE (and the z-loss term when return_z_term);
    ``denom`` as in ``softmax_cross_entropy``.
    """
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    yf = labels.reshape(-1)
    nll, logz = _ChunkedNLL.apply(xf, lm_head, yf, vocab_chunk)
    z_sq = torch.square(logz)
    if z_loss:
        nll = nll + z_loss * z_sq
    total = _masked_mean(nll, yf, ignore_index, denom)
    if return_z_term:
        return total, z_loss * _masked_mean(z_sq, yf, ignore_index, denom)
    return total


class _VocabParallelNLL(torch.autograd.Function):
    """(nll, logz) per row for a head split over ``axis`` by vocab: this
    rank's logits are ``y @ w`` over its contiguous slice, ``chunk``
    columns at a time (0: the whole slice at once).

    Forward: the local online max and sum-exp, then one pmax of the local
    max (no gradient: a numerical shift the value and gradient do not
    depend on), one psum of the sum-exp rescaled to it, and one psum of
    the picked label logit (zero on the ranks that do not own the label).
    Backward: this rank's logits recomputed chunk by chunk from the saved
    y, w and logz; it returns the head slice's gradient and this slice's
    share of dy. The caller enters ``y`` through ``copy_to``, whose
    backward sums the shares over the axis."""

    @staticmethod
    def forward(ctx, y, w, labels, axis, chunk):
        n, vshard = y.shape[0], w.shape[1]
        offset = axis.index * vshard
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=y.device)
        s = torch.zeros((n,), dtype=torch.float32, device=y.device)
        lab = torch.zeros((n,), dtype=torch.float32, device=y.device)
        bounds = _chunk_bounds(vshard, chunk or vshard)
        for c0, c1 in bounds:
            z = (y @ w[:, c0:c1]).float()
            m_new = torch.maximum(m, z.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(-1)
            m = m_new
            local = labels - offset - c0
            hit = (local >= 0) & (local < c1 - c0)
            picked = torch.gather(z, 1, local.clamp(0, c1 - c0 - 1)[:, None].long())[:, 0]
            lab = torch.where(hit, picked, lab)
        gmax = collectives.pmax(m, axis)
        sumexp = collectives._psum(s * torch.exp(m - gmax), axis)
        logz = gmax + torch.log(sumexp)
        label = collectives._psum(lab, axis)
        ctx.save_for_backward(y, w, labels, logz)
        ctx.offset, ctx.bounds = offset, bounds
        return logz - label, logz

    @staticmethod
    def backward(ctx, g, gz):
        # d nll/d z = softmax - onehot, d logz/d z = softmax; dy sums in f32.
        y, w, labels, logz = ctx.saved_tensors
        gp = g + gz
        dy = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
        dw = torch.empty_like(w)
        for c0, c1 in ctx.bounds:
            w_c = w[:, c0:c1]
            z = (y @ w_c).float()
            dz = torch.exp(z - logz[:, None]) * gp[:, None]
            local = labels - ctx.offset - c0
            rows = torch.nonzero((local >= 0) & (local < c1 - c0)).squeeze(-1)
            dz[rows, local[rows].long()] -= g[rows]
            dz = dz.to(y.dtype)
            dy += (dz @ w_c.T).float()
            dw[:, c0:c1] = y.T @ dz
        return dy.to(y.dtype), dw, None, None, None


def vocab_parallel_cross_entropy(
    y: torch.Tensor, lm_head_shard: torch.Tensor, labels: torch.Tensor, axis,
    ignore_index: int | None = None, reduction: str = "mean", z_loss: float = 0.0,
    *, denom=None, vocab_chunk: int = 0, return_z_term: bool = False,
):
    """Token CE with the LM head split by vocab over the mesh ``axis`` (an
    ``Axis``, ``Mesh.axis(name)``).

    ``y`` [..., D] is the same on every rank of the axis and enters
    through ``collectives.copy_to``; ``lm_head_shard`` [D, V/n] is this
    rank's contiguous vocab slice (rank i owns ids [i*V/n, (i+1)*V/n));
    ``labels`` are global ids. The full [..., V] logits never exist on a
    rank. ``reduction`` "mean" is the masked mean (``denom``: a shard's
    share of a global mean, as ``softmax_cross_entropy`` takes it), "sum"
    the masked sum. ``vocab_chunk`` > 0 walks the local slice that many
    columns at a time. With ``return_z_term``, also z_loss x the masked
    mean of logsumexp^2."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    d = y.shape[-1]
    yf = collectives.copy_to(y.reshape(-1, d), axis)
    lf = labels.reshape(-1)
    nll, logz = _VocabParallelNLL.apply(yf, lm_head_shard, lf, axis, vocab_chunk)
    z_sq = torch.square(logz)
    if z_loss:
        nll = nll + z_loss * z_sq

    def reduce(v):
        if reduction == "sum":
            keep = (lf != ignore_index).float() if ignore_index is not None else 1.0
            return torch.sum(v * keep)
        return _masked_mean(v, lf, ignore_index, denom)

    total = reduce(nll)
    if return_z_term:
        return total, z_loss * reduce(z_sq)
    return total
