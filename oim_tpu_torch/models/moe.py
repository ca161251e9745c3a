"""Mixture-of-Experts FFN (``oim_tpu/models/moe.py``): top-k routing with
a capacity limit, the expert SwiGLU as batched products over the experts,
and both dispatch modes of the reference.

"gather" (the default) scatters token ids into an [E, C] buffer, gathers
the tokens into the experts' inputs and each routing round's outputs
back to token positions; "einsum" is GShard's dense one-hot dispatch and
combine. The two give the same numbers (``tests/test_torch_moe.py``).

Every shape is static and nothing syncs the host: a token over capacity
is dropped by index arithmetic, never by a boolean mask or ``nonzero``.
The reference's ``.at[].set(mode="drop")`` sends a dropped token to the
out-of-range slot C; torch raises on such an index, so the gather
buffers carry a dump column C that is sliced off.

The router runs in float32 with autocast off and refuses TF32: a route is
an argmax, which a low-precision product can flip. Expert products run in
the model dtype and lower to ``aten.bmm``, so remat's
"dots_with_no_batch_dims" recomputes them as JAX's policy does (batch dim
E). Expert parallelism (``param_logical_axes``, the "expert" mesh axis
and its all-to-alls) comes with a later multi-GPU slice (ROADMAP A.6,
item 3); until then the trainer refuses MoE under a mesh of several
ranks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dispatch: str = "gather"  # or "einsum"


def init(rng: torch.Generator, dim: int, mlp_dim: int, cfg: MoEConfig, dtype,
         n_layers: int | None = None, device=None) -> dict:
    """Expert FFN params drawn from ``rng``; with n_layers, stacked
    [L, ...]. The router is float32 whatever ``dtype``."""
    device = rng.device if device is None else torch.device(device)
    lead = () if n_layers is None else (n_layers,)
    e = cfg.n_experts
    fan = dim ** -0.5

    def normal(shape, scale, dt):
        x = torch.randn(lead + shape, generator=rng, dtype=torch.float32, device=device)
        return (x * scale).to(dt)

    return {
        "router": normal((dim, e), fan, torch.float32),
        "w_gate": normal((e, dim, mlp_dim), fan, dtype),
        "w_up": normal((e, dim, mlp_dim), fan, dtype),
        "w_down": normal((e, mlp_dim, dim), mlp_dim ** -0.5, dtype),
    }


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return max(1, int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts))


def _router_probs(tokens, router):
    """softmax(tokens @ router) in true float32."""
    if tokens.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "MoE routing needs full-float32 products: TF32 is on "
            "(torch.set_float32_matmul_precision / allow_tf32)")
    with torch.autocast(tokens.device.type, enabled=False):
        logits = tokens.float() @ router.float()
    return torch.softmax(logits, dim=-1)


def router_margin(router, x, k: int, set_only: bool = False) -> torch.Tensor:
    """How far the routes of ``x`` are from a tie: over tokens, the least
    gap between consecutive router probabilities among the top k+1 (a 0-d
    tensor). ``set_only`` takes only the gap between the k-th and the next,
    the one that decides which experts run when nothing is dropped. A route
    whose margin is below the noise of the arithmetic can flip between two
    devices or batch shapes. A diagnostic: ``apply`` never calls it."""
    with torch.no_grad():
        probs = _router_probs(x.reshape(-1, router.shape[0]), router)
        top = probs.sort(dim=-1, descending=True).values
        gaps = top[:, :-1] - top[:, 1:]
        return (gaps[:, k - 1] if set_only else gaps[:, :k]).min()


def _one_hot(idx, n: int, dtype):
    """[N] -> [N, n]. F.one_hot checks its indices with ``.item()`` on the
    CPU; a comparison checks nothing and never syncs."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(probs, k: int, cap: int):
    """The top-k rounds: per round (gate, expert, pos, keep), [N] each.
    argmax takes the first of tied experts; a token's slot is its rank
    among this round's tokens of its expert after the slots earlier
    rounds filled; ``keep`` is pos < cap, and pos is then clipped."""
    e = probs.shape[-1]
    remaining = probs
    fill = torch.zeros(e, dtype=torch.long, device=probs.device)
    rounds = []
    for _ in range(k):
        gate = remaining.amax(dim=-1)
        expert = remaining.argmax(dim=-1)
        onehot = _one_hot(expert, e, torch.long)  # [N, E]
        pos = ((onehot.cumsum(dim=0) - 1 + fill) * onehot).sum(dim=-1)
        keep = pos < cap
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        rounds.append((gate, expert, pos.clamp(0, cap - 1), keep))
        remaining = remaining * (1.0 - onehot.float())
    if k > 1:
        # Renormalise over the experts used (GShard). k == 1 keeps the raw
        # router probability (Switch): a gate of 1 would carry no gradient.
        denom = sum(torch.where(keep, gate, 0.0) for gate, _, _, keep in rounds)
        denom = torch.clamp(denom, min=1e-9)
        rounds = [(gate / denom, expert, pos, keep) for gate, expert, pos, keep in rounds]
    return rounds


def _expert_ffn(params, expert_in):
    """[E, C, D] -> [E, C, D]: the SwiGLU of each expert, shared by both
    dispatch modes."""
    h = F.silu(torch.bmm(expert_in, params["w_gate"])) * torch.bmm(expert_in, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _gather_dispatch(params, tokens, rounds, e: int, cap: int):
    n, d = tokens.shape
    dev = tokens.device
    ids = torch.arange(n, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    # Column `cap` is the dump slot of dropped tokens; each real (expert,
    # pos) pair is written at most once across rounds.
    idx_buf = torch.zeros(e, cap + 1, dtype=torch.long, device=dev)
    valid = torch.zeros(e, cap + 1, dtype=torch.bool, device=dev)
    for _, expert, pos, keep in rounds:
        pos_w = torch.where(keep, pos, cap)
        idx_buf = idx_buf.index_put((expert, pos_w), ids)
        valid = valid.index_put((expert, pos_w), true)
    idx_buf, valid = idx_buf[:, :cap], valid[:, :cap]
    expert_in = tokens.index_select(0, idx_buf.reshape(-1)).reshape(e, cap, d)
    expert_in = expert_in * valid[..., None].to(tokens.dtype)
    flat_out = _expert_ffn(params, expert_in).reshape(e * cap, d)
    out = torch.zeros(n, d, dtype=tokens.dtype, device=dev)
    for gate, expert, pos, keep in rounds:
        picked = flat_out.index_select(0, expert * cap + pos)
        out = out + picked * (gate * keep).to(tokens.dtype)[:, None]
    return out


def _einsum_dispatch(params, tokens, rounds, e: int, cap: int):
    n = tokens.shape[0]
    combine = torch.zeros(n, e, cap, dtype=torch.float32, device=tokens.device)
    dispatch = torch.zeros(n, e, cap, dtype=torch.bool, device=tokens.device)
    for gate, expert, pos, keep in rounds:
        onehot = _one_hot(expert, e, torch.float32)
        slot = _one_hot(pos, cap, torch.float32)
        contrib = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
        combine = combine + gate[:, None, None] * contrib
        dispatch = dispatch | (contrib > 0)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(tokens.dtype), tokens)
    return torch.einsum("nec,ecd->nd", combine.to(tokens.dtype),
                        _expert_ffn(params, expert_in))


_DISPATCH = {"gather": _gather_dispatch, "einsum": _einsum_dispatch}


def apply(params, x, cfg: MoEConfig, with_stats: bool = False):
    """x [B, T, D] -> (out [B, T, D], aux). ``aux`` is the f32 load-balance
    loss, or with ``with_stats`` the f32 vector [aux, dropped], dropped
    being the share of the N*k routing assignments over capacity (no
    gradient). A dropped assignment contributes zero; the residual
    stream carries its token."""
    if cfg.dispatch not in _DISPATCH:
        raise ValueError(f"unknown MoE dispatch mode {cfg.dispatch!r} "
                         "(valid: 'gather', 'einsum')")
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(n, cfg)
    tokens = x.reshape(n, d)
    probs = _router_probs(tokens, params["router"])
    rounds = _route(probs, k, cap)
    out = _DISPATCH[cfg.dispatch](params, tokens, rounds, e, cap).reshape(b, t, d)

    # Switch Transformer's load-balance loss: E * sum_e (share of tokens
    # whose top expert is e) * (mean router probability of e).
    frac_tokens = _one_hot(probs.argmax(dim=-1), e, torch.float32).mean(dim=0)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    if not with_stats:
        return out, aux
    kept = sum(keep.float().sum() for _, _, _, keep in rounds)
    dropped = (1.0 - kept / (n * k)).detach()
    return out, torch.stack([aux, dropped])
