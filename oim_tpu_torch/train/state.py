"""Train state and optimizer (``oim_tpu/train/state.py``).

``make_optimizer`` is the JAX package's optax chain written out, step for
step: ``clip_by_global_norm(grad_clip)`` then ``adamw(schedule, b1, b2,
eps=1e-8, weight_decay)`` (decay on every leaf) under
``warmup_cosine_decay_schedule``. Two details of optax that torch's own
optimizers do differently, kept here:

* the schedule is evaluated at the count BEFORE the increment, so the
  first update runs at lr = schedule(0) (0 with a warmup from 0);
* the clip scales by max_norm / norm only when norm >= max_norm, with no
  epsilon (``clip_grad_norm_`` adds 1e-6 to the norm).

The moments keep the param dtype (optax's ``mu_dtype=None``). Updates are
applied in place, leaf by leaf, so the step holds one leaf's temporaries
at a time.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class OptState:
    count: int  # updates applied so far
    mu: dict
    nu: dict


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    opt_state: OptState
    # The model's mutable state, carried by the step with no gradient
    # through it: {} for llama, the BN running statistics for ResNet.
    extra: dict = dataclasses.field(default_factory=dict)


def tree_leaves(tree):
    """Leaves of a nested dict in sorted-key order (jax.tree_util's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in tree_leaves order."""
    return _build(like, iter(leaves))


def _build(t, it):
    # A module-level recursion: a nested closure that calls itself is a
    # reference cycle, which would keep ``leaves`` (a step's gradients)
    # alive until the next garbage collection.
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    warmup_steps, then cosine from peak to end_value at decay_steps."""
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


class AdamW:
    """clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    scale by -schedule(count), as the optax chain composes them."""

    def __init__(self, schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, grad_clip: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params) -> OptState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return OptState(count=0, mu=_map(zeros, params), nu=_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params, norm=None) -> torch.Tensor:
        """Apply one update in place to ``params``, ``state.mu`` and
        ``state.nu``; returns the pre-clip global grad norm (f32 scalar).
        ``norm`` is that norm when the caller holds shards of the gradients
        (the trainer under a mesh sums their squares over the shards); by
        default it is ``global_norm(grads)``."""
        if norm is None:
            norm = global_norm(grads)
        clip = bool(norm >= self.grad_clip)
        count = state.count + 1
        # bias corrections in f32 (optax: 1 - decay**count, f32 count)
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = one - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = one - torch.tensor(self.b2, dtype=torch.float32) ** count
        lr = -self.schedule(state.count)
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.mu), tree_leaves(state.nu)):
            if clip:
                g = (g / norm.to(g.dtype)) * self.grad_clip
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g ** 2 + self.b2 * nu)
            mu_hat = mu / bc1.to(mu.device, mu.dtype)
            nu_hat = nu / bc2.to(nu.device, nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            u = torch.tensor(lr, dtype=u.dtype, device=u.device) * u
            p.copy_((p + u).to(p.dtype))
        state.count = count
        return norm


def make_optimizer(
    lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW with linear warmup + cosine decay and global-norm clipping."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1), end_value=lr * 0.1)
    return AdamW(schedule, b1=b1, b2=b2, eps=1e-8, weight_decay=weight_decay,
                 grad_clip=grad_clip)
