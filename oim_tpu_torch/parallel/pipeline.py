"""Pipeline parallelism: GPipe over a ``pipe`` mesh axis
(``oim_tpu/parallel/pipeline.py``).

Layers are stacked along a leading [L, ...] axis; PIPE_RULES splits it over
``pipe``, so rank d holds its L/P contiguous layers (``pipeline_stage_slice``)
and M microbatches stream through the stages, each stage handing its output
to the next.

Schedule: plain GPipe, M + P - 1 ticks forward (stage s runs microbatch
t - s at tick t), then the head on every microbatch, then M + P - 1 ticks
backward in reverse order. Bubble (P-1)/(M+P-1): M >= 4P keeps it under
~20%. GPipe's memory law: each stage keeps the graphs of all M
microbatches until the backward, O(M) a stage, the regime 1F1B
(``parallel/pipeline_1f1b.py``) exists for.

The JAX package differentiates its SPMD tick loop through ``ppermute``,
whose transpose is the reverse rotation. Autograd does not cross
processes, so the port drives the reverse pass itself: a stage keeps each
microbatch's input (a leaf with ``requires_grad``) and output, and once
the head has given the last stage its cotangents, each stage runs its
microbatches' backward in reverse tick order with the cotangent received
from the right and hands its input's gradient to the left
(``collectives.send_recv``: only the pairs that carry a real microbatch
post a message). Idle ticks compute nothing, so the MoE aux is counted
for the real (stage, microbatch) pairs alone.

The head runs on every rank of the axis: the last stage's output for a
microbatch is broadcast over it (a psum where the others send zeros), so
a head split over the axis (the vocab-parallel LM head) takes its
collectives on every rank, and each rank differentiates it seeded with
the microbatch's weight. Its cotangent comes out whole on every rank; the
last stage seeds its backward with it. ``pipeline_value_and_grad`` returns
the gradients of sum_j w_j * head_j + aux_seed . sum(aux): stage
parameters (summed in f32 over the microbatches, then cast to their
dtype) and head parameters. Global stage 0's inputs come from a ``Feed``
when that stage first reads them, and their cotangents go back to it as
that stage makes them, one microbatch at a time: a feed that computes its
inputs (the vocab-parallel embedding) holds no more of them, or of their
cotangents, than the schedule keeps live.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.mesh import Axis

# send_recv tags: activations travel right, cotangents left.
TAG_FWD, TAG_BWD = 1, 2

StageFn = Callable[[torch.Tensor, int], tuple]  # (h, chunk) -> (out, aux)
HeadFn = Callable[[torch.Tensor, int], tuple]  # (h, microbatch) -> (loss, extra | None)


def pipeline_stage_slice(n_layers: int, axis_size: int, stage: int) -> slice:
    """Which layers stage ``stage`` owns (contiguous blocks)."""
    if n_layers % axis_size:
        raise ValueError(f"{n_layers} layers not divisible by {axis_size} stages")
    per = n_layers // axis_size
    return slice(stage * per, (stage + 1) * per)


@dataclasses.dataclass
class PipeResult:
    """What a pipelined pass returns on each rank of the axis.

    ``loss``: sum_j w_j * head_j, the same on every rank (no aux term);
    ``aux``: the stage aux vectors summed over this rank's real (stage,
    microbatch) pairs (None without aux); ``extra``: sum_j w_j * extra_j
    of the head's extra output (None without it); ``d_stage``: one list of
    gradients a chunk, like the chunks' params; ``d_head``. The inputs'
    cotangents went to the ``Feed``. The gradients are None for a
    forward-only pass."""

    loss: torch.Tensor
    aux: torch.Tensor | None = None
    extra: torch.Tensor | None = None
    d_stage: list | None = None
    d_head: list | None = None


class Feed:
    """Global stage 0's M microbatch inputs and the sink of their
    cotangents. An executor calls ``take(j)`` at the tick that stage first
    reads microbatch j, and ``give(j, d)`` at the tick its backward makes
    d_j, at the same point on every rank of the axis, so either may run
    collectives over it: ``take`` returns the input on the axis's first
    rank (anything elsewhere), ``give`` gets the cotangent there (None
    elsewhere). ``like`` has a microbatch input's shape, dtype and device.
    This feed holds ``xs`` and keeps the cotangents in ``d_x`` on the first
    rank."""

    def __init__(self, xs: list):
        self.xs, self.like, self.n = xs, xs[0], len(xs)
        self.d_x: list = [None] * self.n

    def take(self, j: int) -> torch.Tensor:
        return self.xs[j]

    def give(self, j: int, d: torch.Tensor | None) -> None:
        self.d_x[j] = d


class Grads:
    """Gradient sums of a list of tensors, in f32 (a low-precision sum
    drops low bits every add), cast to each tensor's dtype at the end."""

    def __init__(self, like: list):
        self.like = like
        self.sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in like]

    def add(self, grads) -> None:
        for a, g in zip(self.sums, grads):
            a += g.float()

    def result(self) -> list:
        return [a.to(p.dtype) for a, p in zip(self.sums, self.like)]


def broadcast_from(y: torch.Tensor | None, axis: Axis, src: int, like: torch.Tensor):
    """``y`` of the rank at index ``src`` on every rank of the axis: a psum
    to which the others add zeros shaped like ``like``."""
    mine = y if axis.index == src else torch.zeros_like(like)
    return collectives._psum(mine.detach(), axis)


class Head:
    """The head of each microbatch on every rank: its loss (weighted sum),
    extra output, parameter gradients and the cotangent of its input."""

    def __init__(self, head_fn: HeadFn, params: list, weights, grad: bool):
        self.fn, self.params, self.weights, self.grad = head_fn, params, weights, grad
        self.grads = Grads(params) if grad else None
        self.loss = None
        self.extra = None

    def __call__(self, h: torch.Tensor, j: int):
        """Runs the head on microbatch j's (broadcast) last-stage output;
        returns dL/dh (None for a forward-only pass)."""
        w = self.weights[j]
        h = h.detach().requires_grad_(self.grad)
        with torch.set_grad_enabled(self.grad):
            loss, extra = self.fn(h, j)
        dh = None
        if self.grad:
            seed = torch.as_tensor(w, dtype=loss.dtype, device=loss.device)
            dh, *dp = torch.autograd.grad(loss, [h, *self.params], seed)
            self.grads.add(dp)
        loss = loss.detach() * w
        self.loss = loss if self.loss is None else self.loss + loss
        if extra is not None:
            extra = extra.detach() * w
            self.extra = extra if self.extra is None else self.extra + extra
        return dh


def stage_backward(h, out, aux, params: list, dh, aux_seed):
    """A stage's graph from its input leaf ``h`` to (``out``, ``aux``)
    differentiated, seeded with ``dh`` (and ``aux_seed`` on the aux
    vector): (d_h, d_params, aux detached)."""
    outs, seeds = [out], [dh.to(out.dtype)]
    if aux_seed is not None:
        outs.append(aux)
        seeds.append(aux_seed.to(aux.dtype))
    d_h, *d_params = torch.autograd.grad(outs, [h, *params], seeds)
    return d_h, d_params, aux.detach() if aux is not None else None


def add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def pipeline_value_and_grad(stage_fn: StageFn, head_fn: HeadFn, stage_params: list,
                            head_params: list, feed: Feed, weights, axis: Axis,
                            aux_seed: torch.Tensor | None = None,
                            grad: bool = True) -> PipeResult:
    """GPipe over ``axis`` on this rank's stage.

    stage_fn(h, 0) -> (out, aux): this rank's layers on h (aux a f32
        vector, or None); out has h's shape and dtype.
    head_fn(h, j) -> (loss_j, extra_j or None): microbatch j's head on the
        last stage's output, run on every rank of the axis.
    stage_params / head_params: the tensors to differentiate.
    feed: the M microbatch inputs of stage 0 and the sink of their
        cotangents (``Feed``).
    weights: M seeds of the head losses (floats or 0-d tensors).
    aux_seed: the cotangent of each (stage, microbatch)'s aux vector.
    grad=False is the forward only (an eval pass)."""
    p, s, m = axis.size, axis.index, feed.n
    like = feed.like
    shape, dtype, device = tuple(like.shape), like.dtype, like.device
    kept: list = [None] * m
    aux_total = None
    recv = None
    for t in range(m + p - 1):
        j, out = t - s, None
        x = feed.take(t) if t < m else None  # stage 0 reads microbatch t now
        if 0 <= j < m:
            h = x if s == 0 else recv
            h = h.detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                out, aux = stage_fn(h, 0)
            if grad:
                kept[j] = (h, out, aux)
            elif s == p - 1:
                kept[j] = out
            aux_total = add_aux(aux_total, None if aux is None else aux.detach())
        sends = [(out, s + 1, TAG_FWD)] if out is not None and s < p - 1 else []
        recvs = [(shape, dtype, s - 1, TAG_FWD)] if s > 0 and 0 <= t - s + 1 < m else []
        got = collectives.send_recv(axis, sends, recvs, device)
        recv = got[0] if got else None

    head = Head(head_fn, head_params, weights, grad)
    dh_last = []
    for j in range(m):
        last = None
        if s == p - 1:
            last = kept[j][1] if grad else kept[j]
        dh_last.append(head(broadcast_from(last, axis, p - 1, like), j))
    if not grad:
        return PipeResult(head.loss, aux_total, head.extra)

    grads = Grads(stage_params)
    recv = None
    for t in reversed(range(m + p - 1)):
        j, d_in = t - s, None
        if 0 <= j < m:
            dh = dh_last[j] if s == p - 1 else recv
            d_in, d_params, _ = stage_backward(*kept[j], stage_params, dh, aux_seed)
            kept[j] = None  # the graph goes as soon as it is used
            grads.add(d_params)
        if t < m:  # stage 0 has made microbatch t's cotangent
            feed.give(t, d_in if s == 0 else None)
        sends = [(d_in, s - 1, TAG_BWD)] if d_in is not None and s > 0 else []
        recvs = ([(shape, dtype, s + 1, TAG_BWD)]
                 if s < p - 1 and 0 <= t - s - 1 < m else [])
        got = collectives.send_recv(axis, sends, recvs, device)
        recv = got[0] if got else None
    return PipeResult(head.loss, aux_total, head.extra, [grads.result()],
                      head.grads.result())
