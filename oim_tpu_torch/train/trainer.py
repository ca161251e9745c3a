"""The trainer (``oim_tpu/train/trainer.py``): the train step over a mesh
of ranks, its evaluation, and the loop that logs loss, grad_norm, step_s
and mfu, evaluates and checkpoints.

Ported: ``TrainConfig`` for the llama models (dense and MoE) and resnet50
(with remat and its policies), ``make_train_step`` with gradient
accumulation, ``synthetic_batches`` (the same numpy streams as the JAX
package), ``flops_per_step`` (an MoE model's on its active parameters),
``peak_flops_per_device`` and ``peak_hbm_bw_per_device`` (keyed on the
CUDA device name), and ``Trainer`` with ``init_or_resume``, ``evaluate``
and ``run``. A model's stats (an MoE model's ``moe_drop_frac``) ride the
step's stats, averaged over the microbatches, into the history. Each step
runs in a ``train.step`` span, and on a torch profiler's trace its parts
in ``train.forward_backward``, ``train.grad_norm``, ``train.optimizer``
and ``train.feed`` ranges (``tracing.device_range``: no-ops with no
profiler recording); each logged step sets the ``oim_train_*``,
``oim_feed_wait_seconds`` and ``oim_moe_drop_fraction`` gauges from the
values it logs, and each eval pass ``oim_eval_loss`` (and
``oim_eval_accuracy``).

Meshes: the rules "dp", "fsdp" and "tp_sp" over the axes data, fsdp, seq,
model and expert, each rank one process of ``torch.distributed`` holding
its rows of the batch, its part of the sequence when ``seq`` > 1 (ring,
zigzag or Ulysses attention, ``parallel/ring.py``) and its shards of the
parameters and moments. The step computes the JAX meshed step's function:
the label shift is taken on the global tokens, the loss is the global
mean (each rank's sum over the global count of kept labels, summed over
the axes that split the batch or the sequence), a weight sharded over
fsdp is gathered before use and its gradient reduce-scattered (its
backward), every gradient is then summed over the other splitting axes,
and the clip sees the global norm. Under tp_sp a ``model`` axis of more
than one rank is tensor parallelism: the heads, the MLP and the
vocabulary stay split over it (``llama``'s TP layer, where a head may
straddle two ranks, and ``vocab_parallel_cross_entropy``); an ``expert``
axis of more than one rank is expert parallelism (``moe.MeshContext``:
each rank its share of the experts). The ranks of either axis hold the
same tokens, so no gradient is summed over it, a replicated leaf's
gradient is already whole on each of them, and a split leaf's squares
are summed over it for the norm. An MoE model routes the global token set (``models/moe.py``).
ResNet-50 runs over the batch axes with its batch norm's statistics
taken over the global batch and its running statistics replicated. A
checkpoint under a mesh is written in pieces and resumes under any mesh
(``train/checkpoint.py``).

Rules "pipe" (``PIPE_RULES``): the stacked layers split over a ``pipe``
axis, L/P contiguous layers a rank, and embed's and lm_head's vocabulary
over it too; ``microbatches`` stream through the stages under
``pipeline_schedule`` "gpipe" or "1f1b" (``virtual_stages`` > 1: the
interleaved 1F1B), with ``data`` splitting the batch and ``seq`` the
sequence inside every stage (``llama.make_pipelined_loss`` and
``make_1f1b_loss``). The pipeline computes its own gradients (autograd
does not cross ranks); the eval forward is always GPipe's. An MoE model
routes each rank's tokens of each microbatch, as the JAX package does
inside its pipeline. A ``model`` or ``expert`` axis beside ``pipe``
splits nothing (``PIPE_RULES`` maps neither): its ranks run the same
pipeline on the same tokens, as the JAX trainer replicates over it.

``check_supported`` takes every mesh the JAX trainer takes. Ulysses
attention over a ``seq`` axis beside a ``model`` axis that splits a query
head runs on the whole heads, gathered over ``model`` (``_heads_gathered``).

A batch leaf may be a ``plane.Placed``, staged under a placement over the
trainer's mesh (``CUDABackend(mesh=...)``): ``place_batch`` takes this
rank's tensor as it lies where its layout is the cut it would make.

PyTorch runs eagerly, so the step is a plain function: forward, backward
through ``torch.autograd.grad``, the gradients' sums over ranks, then the
optimizer's in-place update. Checkpoints are the port's own format
(``train/checkpoint.py``), not orbax's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common import tracing
from oim_tpu_torch.common.device import require
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.data import plane
from oim_tpu_torch.models import llama, moe, resnet
from oim_tpu_torch.ops.losses import accuracy, softmax_cross_entropy
from oim_tpu_torch.parallel.collectives import all_gather, psum
from oim_tpu_torch.parallel.mesh import Axis, Mesh, build_mesh
from oim_tpu_torch.parallel.pipeline import pipeline_stage_slice
from oim_tpu_torch.parallel.ring import make_sequence_parallel_attention, shard_positions
from oim_tpu_torch.parallel.sharding import (
    BATCH,
    DP_RULES,
    EXPERT,
    FSDP_RULES,
    HEAD,
    PIPE_RULES,
    TP_SP_RULES,
    Sharding,
    gather_params,
    logical_sharding,
    param_shardings,
    shard_batch,
    tree_map,
)
from oim_tpu_torch.train.checkpoint import Checkpointer, Layout
from oim_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    tree_leaves,
    tree_unflatten,
)

RULES = {
    "dp": DP_RULES,
    "fsdp": FSDP_RULES,
    "tp_sp": TP_SP_RULES,
    "pipe": PIPE_RULES,
}

# Peak dense bf16 FLOP/s and HBM bytes/s per device, for MFU and
# roofline accounting, matched against torch.cuda.get_device_name() in
# order (NVIDIA data sheets; the PCIe H100 before the SXM part, whose
# name it contains).
PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
    ("h200", 989e12),
)
PEAK_HBM_BW = (
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
    ("h200", 4.8e12),
)


def _lookup_peak(table, device) -> float:
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device).lower()
    for key, val in table:
        if key in name:
            return val
    return 0.0


def peak_flops_per_device(device="cuda") -> float:
    """Peak bf16 FLOP/s of ``device``; 0.0 for a CPU or an unknown card."""
    return _lookup_peak(PEAK_FLOPS, device)


def peak_hbm_bw_per_device(device="cuda") -> float:
    """Peak HBM bytes/s of ``device``; 0.0 for a CPU or an unknown card.
    A bandwidth-bound model (ResNet in bf16) is judged by this share."""
    return _lookup_peak(PEAK_HBM_BW, device)


@dataclasses.dataclass
class TrainConfig:
    model: str = "llama-tiny"  # llama-tiny | llama-tiny-moe | llama3-8b | resnet50
    rules: str = "dp"  # dp | fsdp | tp_sp | pipe
    seq_parallel: str = "ring"  # ring | zigzag | ulysses (mesh seq axis > 1;
    # zigzag = load-balanced causal ring: equal per-step work on every rank)
    microbatches: int = 4  # pipeline microbatch count (rules == "pipe")
    # "gpipe" or "1f1b" (live activations O(P) not O(M); needs
    # microbatches % pipe == 0). Both serve MoE and a seq axis in the pipe.
    pipeline_schedule: str = "gpipe"
    # Interleaved 1F1B: v virtual stages (layer chunks) a rank, bubble
    # (P-1)/(v*M+P-1). Needs pipeline_schedule="1f1b" and
    # n_layers % (pipe * v) == 0.
    virtual_stages: int = 1
    remat: bool = False  # recompute activations in bwd (fit big configs)
    remat_policy: str = ""  # "", "dots", "dots_with_no_batch_dims", "nothing"
    accum_steps: int = 1  # gradient accumulation: split the batch, one update
    batch_size: int = 8
    seq_len: int = 128
    image_size: int = 224
    num_classes: int = 1000
    # Added to every label an image feed reads (ImageNet-convention
    # records are 1-based: -1), before the check against num_classes.
    label_offset: int = 0
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    eval_every: int = 0  # run an eval pass every N steps (0 = off)
    eval_steps: int = 8  # batches per eval pass
    seed: int = 0
    # dataclasses.replace overrides applied to the named model's config
    # (e.g. a tiny-depth llama3-8b for dryruns: full vocab, 2 layers).
    model_overrides: dict = dataclasses.field(default_factory=dict)

    def model_config(self):
        if self.model == "llama-tiny":
            mcfg = llama.tiny()
        elif self.model == "llama-tiny-moe":
            mcfg = llama.tiny(n_experts=4)
        elif self.model == "llama3-8b":
            mcfg = llama.LLAMA3_8B
        elif self.model == "resnet50":
            mcfg = resnet.Config(num_classes=self.num_classes)
        else:
            raise ValueError(f"unknown model {self.model!r} "
                             "(ported: llama-tiny, llama-tiny-moe, llama3-8b, resnet50)")
        if self.remat_policy and not self.remat:
            raise ValueError(
                "remat_policy without remat does nothing — pass remat=True "
                "(--remat) to enable policy-limited rematerialization")
        if self.remat:
            mcfg = dataclasses.replace(mcfg, remat=True)
            if self.remat_policy:
                if not hasattr(mcfg, "remat_policy"):
                    raise ValueError(f"model {self.model!r} does not support remat_policy")
                mcfg = dataclasses.replace(mcfg, remat_policy=self.remat_policy)
        if self.model_overrides:
            mcfg = dataclasses.replace(mcfg, **self.model_overrides)
        return mcfg

    def check_supported(self, mesh: Mesh | None = None) -> None:
        """Refuse what the port cannot run, with the JAX trainer's error
        where it refuses too. An axis the rules do not split over (pipe
        under rules other than "pipe", model and expert beside pipe, a name
        no rule uses) is replicated, as in the JAX trainer."""
        if self.rules not in RULES:
            raise ValueError(f"unknown rules {self.rules!r} (valid: {sorted(RULES)})")
        if self.rules == "pipe" and not self.model.startswith("llama"):
            raise ValueError("pipe rules support llama-family models only")
        mcfg = self.model_config()
        if self.model.startswith("llama"):
            llama.check_supported(mcfg)
        if mesh is None:
            return
        if self.rules == "pipe":
            self._check_pipe(mesh, mcfg)
        n_model = mesh.shape.get("model", 1)
        if n_model > 1 and RULES[self.rules].axis_for(HEAD) == "model" \
                and self.model.startswith("llama"):
            llama.check_tensor_parallel(mcfg, n_model)
            n_seq = mesh.shape.get("seq", 1)
            if (mcfg.n_heads % n_model and n_seq > 1 and self.seq_parallel == "ulysses"
                    and mcfg.n_heads % n_seq):  # the JAX trainer's refusal
                raise ValueError(f"ulysses needs heads ({mcfg.n_heads}) divisible by the "
                                 f"'seq' axis size ({n_seq})")

    def _check_pipe(self, mesh: Mesh, mcfg) -> None:
        """The JAX trainer's refusals of a pipelined run, with its errors."""
        if "pipe" not in mesh.shape:
            raise ValueError(
                "pipe rules need a mesh with a 'pipe' axis "
                f"(got axes {tuple(mesh.shape)}); e.g. --mesh data=2,pipe=2")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"unknown pipeline_schedule {self.pipeline_schedule!r} "
                "(valid: 'gpipe', '1f1b')")
        p, m = mesh.shape["pipe"], self.microbatches
        if self.pipeline_schedule == "1f1b":
            if m % p:
                raise ValueError(
                    f"1F1B shards the microbatch dim over the pipe axis: "
                    f"n_microbatches {m} must divide by pipe size {p}")
            v = max(1, self.virtual_stages)
            if v > 1 and mcfg.n_layers % (p * v):
                raise ValueError(
                    f"{mcfg.n_layers} layers not divisible by pipe {p} x virtual {v}")
        pipeline_stage_slice(mcfg.n_layers, p, 0)  # refuses L % P


def _norm_spec(dims, ndim: int) -> tuple:
    """Per-dim axes padded to ``ndim`` with whole dims, for EQUIVALENCE:
    ("data",), ("data", None) and (("data",), None) shard alike."""
    parts = tuple(dims) + (None,) * (ndim - len(tuple(dims)))
    return tuple(() if not p else tuple(p) if isinstance(p, (tuple, list)) else (p,)
                 for p in parts)


def _gathered(v: plane.Placed, mesh: Mesh) -> torch.Tensor:
    """The global array of a placed leaf: assembled from its shards where
    this process holds every slice, else gathered over ``mesh`` (the
    placement's) from each rank's."""
    if (v.placement.mesh_id != ("ranks", mesh.ranks)
            or v.placement.axes != tuple(mesh.shape.items())):
        return v.assemble()
    return Sharding(v.placement.dims).gather(v.local.to(mesh.device), mesh)


def _heads_gathered(sp, tp: Axis, mcfg):
    """Ulysses over the ``seq`` axis on the heads gathered over ``tp``:
    where a rank's own heads do not split over ``seq`` but the full heads
    do (the JAX package runs sequence parallelism on whole heads), every
    rank of ``tp`` attends every head and keeps its own. Where ``tp``
    splits a head, each rank holds the whole heads its columns touch
    (``llama.head_range``, overlapping its neighbours'): the gather takes
    each head once, from the first rank that holds it, and K/V the same
    way expanded to one head a query head. The gathers' backward sums
    each head's cotangent into the copy taken, and the q gather inside
    the layer then sums a straddling head's shares over its owners
    (trap 11)."""
    n, group = tp.size, mcfg.n_heads // mcfg.n_kv_heads
    ranges = [llama.head_range(mcfg, n, r)[:2] for r in range(n)]
    lo, hi = ranges[tp.index]
    take = None
    if mcfg.n_heads % n:
        width = max(b - a for a, b in ranges)
        take = [next(r * width + h - a for r, (a, b) in enumerate(ranges) if a <= h < b)
                for h in range(mcfg.n_heads)]

    def whole(x):
        if take is None:  # disjoint ranges, each rank's KV heads its own
            return all_gather(x, tp, gather_dim=2)
        x = F.pad(x, (0, 0, 0, width - x.shape[2]))
        return all_gather(x, tp, gather_dim=2)[:, :, torch.tensor(take, device=x.device)]

    def fn(q, k, v):
        if take is not None and k.shape[2] != hi - lo:  # one KV head a query head
            index = torch.arange(lo, hi, device=k.device) // group - lo // group
            k, v = k[:, :, index], v[:, :, index]
        return sp(whole(q), whole(k), whole(v))[:, :, lo:hi]
    return fn


def make_train_step(cfg: TrainConfig, tx, device, mesh: Mesh | None = None):
    """Returns (step_fn, shardings, init_fn, eval_fn).

    ``mesh`` (``parallel.mesh.build_mesh``) places this rank; None is one
    device with no communication. ``shardings`` is the params tree's
    ``Sharding`` tree (the moments follow their params; ResNet's batch
    statistics are whole on every rank).
    ``init_fn(rng, params=None, extra=None)`` builds the TrainState:
    the full params (and the model's mutable state) drawn from the
    torch.Generator ``rng`` on ``device``, or the given ones, cut to this
    rank's shards. ``step_fn(state, batch)`` runs one update in place on
    this rank's rows of the global batch (``Trainer.place_batch``) and returns
    (state, stats) with stats["loss"] and stats["grad_norm"] as f32
    scalars on the device, global and equal on every rank.
    ``eval_fn(state, batch)`` is the forward-only stats: no gradient, no
    update, the model in inference mode (ResNet: running BN statistics,
    the state untouched, and its accuracy).
    """
    if mesh is None:
        mesh = Mesh([("data", 1)], [0], device)
    cfg.check_supported(mesh)
    rules = RULES[cfg.rules]
    mcfg = cfg.model_config()
    accum = max(1, cfg.accum_steps)
    batch_axes = [mesh.axis(a) for a in logical_sharding(mesh, rules, (BATCH,)).axes]
    batch_axes = [a for a in batch_axes if a.size > 1]
    llama_model = cfg.model.startswith("llama")
    n_seq = mesh.shape.get("seq", 1) if llama_model else 1
    # The axes whose ranks hold different tokens (an image has no sequence):
    # a loss or a gradient is summed over them. An axis of size 1 splits
    # nothing and is left out, as XLA elides it.
    split = batch_axes + ([mesh.axis("seq")] if n_seq > 1 else [])
    # The other axes' ranks compute on the same data: a gather over one of
    # them keeps this rank's slice of the (whole) cotangent.
    replicas = tuple(a for a in mesh.axis_names
                     if mesh.shape[a] > 1 and a not in {x.name for x in split})

    # Tensor parallelism: the rules split the heads over a "model" axis of
    # more than one rank; expert parallelism, the experts over "expert".
    def axis_of(logical, name):
        return (mesh.axis(name) if mesh.shape.get(name, 1) > 1
                and rules.axis_for(logical) == name and llama_model else None)

    tp, ep = axis_of(HEAD, "model"), axis_of(EXPERT, "expert")
    keep = tuple(a.name for a in (tp, ep) if a is not None)
    pipe = mesh.axis("pipe") if cfg.rules == "pipe" else None

    if cfg.model.startswith("llama"):
        attn_fn = None
        if n_seq > 1:
            sp = make_sequence_parallel_attention(mesh, kind=cfg.seq_parallel, axis="seq",
                                                  causal=True)
            if tp is not None and cfg.seq_parallel == "ulysses" and (
                    mcfg.n_heads % tp.size or (mcfg.n_heads // tp.size) % n_seq):
                sp = _heads_gathered(sp, tp, mcfg)
            attn_fn = lambda q, k, v, causal=True: sp(q, k, v)  # noqa: E731
        logical = llama.param_logical_axes(mcfg)
        ctx = None
        if mcfg.n_experts and (split or keep) and pipe is None:
            ctx = moe.MeshContext(batch=tuple(batch_axes),
                                  seq=mesh.axis("seq") if n_seq > 1 else None,
                                  layout=cfg.seq_parallel, model=tp, expert=ep)
        positions: dict[int, tuple] = {}

        def seq_shard(t: int):
            """(global positions, their index on the device) of this rank's
            part of a length-t sequence; None without a seq axis."""
            if n_seq == 1:
                return None, None
            if t not in positions:
                pos = shard_positions(t, n_seq, mesh.axis("seq").index, cfg.seq_parallel)
                positions[t] = (pos, torch.from_numpy(pos.astype(np.int64)).to(device))
            return positions[t]

        def init_params(rng):
            return llama.init(rng, mcfg, device=device), {}

        def token_shard(batch):
            """(inputs, labels, positions, global kept-label count) of this
            rank's part of the batch."""
            tokens = batch["tokens"]
            # The label shift is global: taken before the sequence is cut.
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
            pos, index = seq_shard(inputs.shape[1])
            if index is not None:
                inputs, labels = inputs[:, index], labels[:, index]
            with torch.no_grad():
                kept = psum((labels != -1).sum().float(), split)
            return inputs, labels, pos, kept

        if pipe is not None:
            # Each rank's stages compute their own gradients (the pipeline
            # drives its backward across ranks); the eval forward is GPipe's.
            kw = dict(attn_fn=attn_fn, shards=int(np.prod([a.size for a in split])))
            pipe_eval = llama.make_pipelined_loss(mcfg, pipe, cfg.microbatches, **kw)
            pipe_vg = pipe_eval
            if cfg.pipeline_schedule == "1f1b":
                pipe_vg = llama.make_1f1b_loss(mcfg, pipe, cfg.microbatches,
                                               n_virtual=max(1, cfg.virtual_stages), **kw)
            rows = int(np.prod([a.size for a in batch_axes]))

            def pipe_run(fn, params, batch, grad):
                inputs, labels, pos, kept = token_shard(batch)
                b = inputs.shape[0] * rows  # the global batch, as the JAX step sees it
                if b % cfg.microbatches:
                    raise ValueError(f"batch {b} not divisible by {cfg.microbatches} microbatches")
                return fn(params, inputs, labels, positions=pos, denom=kept, grad=grad)

        def loss_fn(params, extra, batch, whole=False):
            """``whole``: the batch is the placed accumulation microbatches
            run at once (an eval pass), whose global order MoE routing
            follows."""
            full = gather_params(mesh, shardings, params, keep, replicas)
            # -1 is loss_and_stats' ignore_index, as in the JAX step.
            inputs, labels, pos, kept = token_shard(batch)
            here = dataclasses.replace(ctx, groups=accum) if whole and ctx else ctx
            loss, stats = llama.loss_and_stats(full, inputs, mcfg, attn_fn, -1, labels=labels,
                                               positions=pos, denom=kept, tp=tp, ctx=here)
            return loss, extra, stats

        def eval_stats(params, extra, batch):
            if pipe is not None:
                loss, _, stats = pipe_run(pipe_eval, params, batch, grad=False)
            else:
                loss, _, stats = loss_fn(params, extra, batch, whole=True)
            return {"loss": loss, **stats}
    else:
        logical = resnet.held_logical_axes(mcfg)

        def init_params(rng):
            return resnet.init(rng, mcfg, device=device)

        def denom(labels):
            """The global batch's row count (None on one rank: the mean)."""
            if not split:
                return None
            return float(labels.shape[0] * int(np.prod([a.size for a in split])))

        def loss_fn(params, extra, batch):
            full = gather_params(mesh, shardings, params, keep, replicas)
            logits, new_extra = resnet.apply(full, extra, batch["images"], mcfg,
                                             training=True, batch_axes=split)
            labels = batch["labels"]
            return softmax_cross_entropy(logits, labels, denom=denom(labels)), new_extra, {}

        def eval_stats(params, extra, batch):
            full = gather_params(mesh, shardings, params, keep, replicas)
            logits, _ = resnet.apply(full, extra, batch["images"], mcfg, training=False)
            labels, n = batch["labels"], denom(batch["labels"])
            acc = (accuracy(logits, labels) if n is None
                   else (torch.argmax(logits, dim=-1) == labels).float().sum() / n)
            return {"loss": softmax_cross_entropy(logits, labels, denom=n), "accuracy": acc}

    shardings = param_shardings(mesh, rules, logical)

    def init_fn(rng: torch.Generator | None, params=None, extra=None) -> TrainState:
        if params is None:
            params, extra = init_params(rng)

        def piece(p, s):
            # A shard is a copy, so the full tensor can go (a conv kernel's
            # slice of output channels stays channels_last).
            part = s.shard(p, mesh)
            return part if part is p else part.clone(memory_format=torch.preserve_format)

        params = tree_map(piece, params, shardings)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return TrainState(step=0, params=params, opt_state=tx.init(params),
                          extra={} if extra is None else extra)

    def grads_of(params, extra, batch):
        if pipe is not None:
            loss, grads, stats = pipe_run(pipe_vg, params, batch, grad=True)
            return loss.detach(), extra, stats, list(tree_leaves(grads))
        leaves = list(tree_leaves(params))
        loss, new_extra, stats = loss_fn(params, extra, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), new_extra, stats, grads

    def reduce_grads(grads):
        """Sum each gradient over the splitting axes its shard's gather did
        not already sum over (a sharded leaf's backward reduce-scattered
        it); then the global norm, each replicated part counted once: a
        leaf's squares are summed over the axes that split it (``model``
        among them), grouped by those axes."""
        out, squares = [], {}
        for g, axes in zip(grads, [s.axes for s in tree_leaves(shardings)]):
            g = psum(g, [a for a in split if a.name not in axes])
            out.append(g)
            key = tuple(a for a in mesh.axis_names if a in axes and mesh.shape[a] > 1)
            squares[key] = squares.get(key, 0.0) + torch.sum(torch.square(g.float()))
        total = sum(psum(sq, [mesh.axis(a) for a in key]) for key, sq in squares.items())
        return out, torch.sqrt(total)

    def step_fn(state: TrainState, batch: dict):
        leaves = list(tree_leaves(state.params))
        with tracing.device_range("train.forward_backward"):
            if accum == 1:
                loss, extra, stats, grads = grads_of(state.params, state.extra, batch)
            else:
                n = next(iter(batch.values())).shape[0]
                if n % accum:
                    raise ValueError(f"batch {n} not divisible by accum_steps {accum}")
                # Accumulate in f32 (a bf16 accumulator drops low bits every
                # add), average, cast back to the param dtype. The model's
                # state runs through the microbatches in order.
                gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                        for p in leaves]
                loss_sum = 0.0
                stats_sum: dict = {}
                extra = state.extra
                for parts in zip(*(v.chunk(accum) for v in batch.values())):
                    loss, extra, mstats, grads = grads_of(state.params, extra,
                                                          dict(zip(batch, parts)))
                    for a, g in zip(gsum, grads):
                        a += g.float()
                    loss_sum = loss_sum + loss
                    for k, v in mstats.items():
                        stats_sum[k] = stats_sum.get(k, 0.0) + v.detach()
                grads = [(a / accum).to(p.dtype) for a, p in zip(gsum, leaves)]
                loss = loss_sum / accum
                stats = {k: v / accum for k, v in stats_sum.items()}
        with torch.no_grad(), tracing.device_range("train.grad_norm"):
            grads, norm = reduce_grads(grads)
        with tracing.device_range("train.optimizer"):
            tx.update(tree_unflatten(state.params, grads), state.opt_state, state.params, norm)
        state.extra = extra
        state.step += 1
        return state, {
            "loss": psum(loss.float(), split),
            "grad_norm": norm,
            **{k: psum(v.detach().float(), split) for k, v in stats.items()},
        }

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dict) -> dict:
        return {k: psum(v.float(), split)
                for k, v in eval_stats(state.params, state.extra, batch).items()}

    return step_fn, shardings, init_fn, eval_fn


def synthetic_batches(cfg: TrainConfig) -> Iterator[dict]:
    """Deterministic host-side batches: the JAX package's numpy stream."""
    rng = np.random.RandomState(cfg.seed)
    mcfg = cfg.model_config()
    while True:
        if cfg.model.startswith("llama"):
            yield {"tokens": rng.randint(
                0, mcfg.vocab, (cfg.batch_size, cfg.seq_len + 1)).astype(np.int32)}
        else:
            yield {
                "images": rng.rand(
                    cfg.batch_size, cfg.image_size, cfg.image_size, 3).astype(np.float32),
                "labels": rng.randint(0, cfg.num_classes, (cfg.batch_size,)).astype(np.int32),
            }


def flops_per_step(cfg: TrainConfig) -> float:
    if cfg.model.startswith("llama"):
        mcfg = cfg.model_config()
        return llama.num_flops_per_token(mcfg, cfg.seq_len) * cfg.batch_size * cfg.seq_len
    # fwd+bwd ~= 3x fwd FLOPs.
    return 3 * resnet.num_flops_per_image(cfg.image_size) * cfg.batch_size


class Trainer:
    """Owns the mesh, the state and the step; run() drives the loop,
    evaluates, checkpoints and logs.

    The mesh: ``mesh``, else one built over every rank of the
    ``torch.distributed`` world from ``axes`` (default: pure DP, one
    "data" axis over the world), else, in a process without a group, one
    device. Every rank draws the same global batches and the same initial
    params (one seed) and keeps its part of each."""

    def __init__(self, cfg: TrainConfig, device="cuda", mesh: Mesh | None = None,
                 axes=None):
        self.cfg = cfg
        self.device = require(device)
        if mesh is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = build_mesh(axes or [("data", world)], device=self.device)
        if mesh.device != self.device:
            raise ValueError(f"the mesh is on {mesh.device}, the trainer on {self.device}")
        if mesh.coordinate is None:
            raise ValueError(f"this rank lies outside the mesh {mesh}")
        self.mesh = mesh
        self.tx = make_optimizer(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                                 total_steps=cfg.total_steps,
                                 weight_decay=cfg.weight_decay)
        self.step_fn, self.shardings, self.init_fn, self.eval_fn = make_train_step(
            cfg, self.tx, self.device, mesh)
        self.state: TrainState | None = None
        self.last_eval_stats: dict[str, float] = {}
        self._sharding_warned: set[str] = set()
        # One record per logged step (step, loss, grad_norm, step_s, mfu,
        # ...) and per eval pass (step, eval_loss, eval_<stat>).
        self.history: list[dict] = []
        self.checkpointer = None
        if cfg.checkpoint_dir:
            layout = Layout(mesh, self.shardings) if mesh.size > 1 else None
            self.checkpointer = Checkpointer(cfg.checkpoint_dir, layout=layout)

    def init(self, params=None, extra=None) -> None:
        """Fresh state from cfg.seed, or from the given full params tree (and
        the model's mutable state: ResNet's BN statistics); under a mesh
        each rank keeps its shards."""
        rng = None
        if params is None:
            rng = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.state = self.init_fn(rng, params, extra)

    def init_or_resume(self) -> int:
        """The latest checkpoint's state, or a fresh one; returns the step
        resumed from (0 for a fresh start). Under a mesh each rank reads
        its pieces under this trainer's shardings, whatever mesh (or one
        process) saved them."""
        if self.checkpointer is not None:
            latest = self.checkpointer.latest_step()
            if latest is not None:
                self.state = self.checkpointer.restore(latest, device=self.device)
                for p in tree_leaves(self.state.params):
                    p.requires_grad_(True)
                from_context().info("resumed", step=latest, dir=self.cfg.checkpoint_dir)
                return latest
        self.init()
        return 0

    def place_batch(self, batch: dict) -> dict:
        """This rank's rows of the global batch on the trainer's device. Each
        leaf is split into the accumulation microbatches first and each
        microbatch cut over the BATCH axes (``shard_batch``), so that a
        rank's i-th local microbatch is its part of the global i-th one, as
        the JAX step splits the global batch before sharding each
        microbatch. Under rules "pipe" each accumulation microbatch is
        split into the pipeline's microbatches first the same way. Where one
        piece holds every row (one rank), a tensor already on the device
        passes through untouched (a feed gathered from a staged volume).

        A device-resident feed (a ``plane.Placed`` leaf: a batch staged
        straight into device memory under a placement over this trainer's
        mesh, ``CUDABackend(mesh=...)``) whose layout is the cut made here
        passes through untouched: this rank's tensor, no host round trip.
        One laid out otherwise is warned about once per key, then gathered
        over the mesh and cut again, every step. So is one laid out as the
        step's cut under accumulation or pipeline microbatches over more
        than one batch piece: the rows this rank holds are not the rows of
        its microbatches (a warning of its own: the placement is right,
        the split is not)."""
        rules, accum = RULES[self.cfg.rules], max(1, self.cfg.accum_steps)
        micro = self.cfg.microbatches if self.cfg.rules == "pipe" else 1
        split = logical_sharding(self.mesh, rules, (BATCH,)).parts(self.mesh, 0)[0] > 1
        placed = {}
        for k, v in batch.items():
            if not isinstance(v, plane.Placed):
                continue
            want = logical_sharding(self.mesh, rules, (BATCH,) + (None,) * (len(v.shape) - 1))
            same = (v.placement.mesh_id == ("ranks", self.mesh.ranks)
                    and v.placement.axes == tuple(self.mesh.shape.items())
                    and _norm_spec(v.placement.dims, len(v.shape))
                    == _norm_spec(want.dims, len(v.shape)))
            if same and (accum * micro == 1 or not split):
                placed[k] = v.local
                continue
            if k not in self._sharding_warned:
                self._sharding_warned.add(k)
                if same:
                    from_context().warning(
                        "device-resident feed cut by rows, not by microbatch; "
                        "re-cutting every step", key=k, accum_steps=accum,
                        microbatches=micro)
                else:
                    from_context().warning(
                        "device-resident feed sharding mismatch; resharding every step",
                        key=k, got=str(v.placement.dims), want=str(want.dims))
            batch = {**batch, k: _gathered(v, self.mesh)}
        batch = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                 for k, v in batch.items() if k not in placed}
        if split:
            parts = {}
            for k, v in batch.items():
                if v.shape[0] % accum:
                    raise ValueError(f"batch {v.shape[0]} not divisible by accum_steps {accum}")
                if v.shape[0] // accum % micro:
                    raise ValueError(
                        f"batch {v.shape[0] // accum} not divisible by {micro} microbatches")
                parts[k] = v.reshape((accum * micro, v.shape[0] // (accum * micro))
                                     + tuple(v.shape[1:]))
            rows = shard_batch(self.mesh, rules, parts, {k: (None, BATCH) for k in parts})
            batch = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in rows.items()}
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        return {**out, **{k: v.to(self.device) for k, v in placed.items()}}

    @torch.no_grad()
    def full_params(self) -> dict:
        """The full params tree, gathered from every rank's shards (each
        rank of the mesh must call it)."""
        params = gather_params(self.mesh, self.shardings, self.state.params)
        return tree_map(lambda p: p.detach(), params)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self, data: Iterator[dict], n_batches: int | None = None) -> float:
        """Forward-only mean loss over n_batches (inference-mode model). A
        finite iterator that runs dry mid-pass ends the pass (mean over
        what ran). Classifier models also report mean accuracy
        (``last_eval_stats``)."""
        n = n_batches or self.cfg.eval_steps
        totals: dict[str, float] = {}
        ran = 0
        for _ in range(n):
            try:
                batch = next(data)
            except StopIteration:
                from_context().warning("eval data exhausted mid-pass", batches_run=ran)
                break
            for k, v in self.eval_fn(self.state, self.place_batch(batch)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            ran += 1
        if ran == 0:
            # Zero batches is not a perfect loss: no plausible-looking 0.0.
            return float("nan")
        self.last_eval_stats = {k: v / ran for k, v in totals.items()}
        loss = self.last_eval_stats["loss"]
        M.EVAL_LOSS.set(loss)
        if "accuracy" in self.last_eval_stats:
            M.EVAL_ACCURACY.set(self.last_eval_stats["accuracy"])
        return loss

    def _fast_forward(self, data, start_step: int) -> None:
        """Position a resumed feed at ``start_step``: ``seek`` where the feed
        has it (``SeekableFeed``), else replay that many batches."""
        seek = getattr(data, "seek", None)
        if callable(seek):
            seek(start_step)
            return
        try:
            for _ in range(start_step):
                next(data)
        except StopIteration:
            raise RuntimeError(
                f"feed exhausted while fast-forwarding to resume step {start_step}: the "
                "resumed feed must cover at least as many batches as the original run "
                "consumed") from None

    def run(self, steps: int | None = None, data: Iterator[dict] | None = None,
            eval_data: Iterator[dict] | None = None) -> float:
        log = from_context()
        cfg = self.cfg
        steps = steps or cfg.total_steps
        synthetic_default = None
        if data is None:
            data = synthetic_default = synthetic_batches(cfg)
        eval_every = cfg.eval_every
        if eval_every and eval_data is None:
            if data is not synthetic_default:
                # A synthetic fallback would report loss on noise while
                # looking like a held-out loss: skip eval loudly instead.
                log.warning("eval_every set but no eval_data supplied for a real feed; "
                            "skipping eval (pass eval_data to run())")
                eval_every = 0
            else:
                # A shifted seed never replays the training batches.
                eval_data = synthetic_batches(dataclasses.replace(cfg, seed=cfg.seed + 10_000))
        restored = False
        if self.state is None:
            start_step = self.init_or_resume()
            restored = start_step > 0
        else:
            start_step = self.state.step
        if restored and start_step < steps:
            # Only when this call restored: an in-memory state carried
            # across run() calls means the caller's feed is positioned.
            self._fast_forward(data, start_step)
        fps = flops_per_step(cfg)
        peak = peak_flops_per_device(self.device) * self.mesh.size
        last_loss = float("nan")
        self._sync()
        t_prev = time.monotonic()
        last_logged = start_step
        # The next batch is placed while the current step's kernels run.
        pending = None
        if start_step < steps:
            with tracing.device_range("train.feed"):
                pending = self.place_batch(next(data))
        feed_wait = 0.0
        for i in range(start_step, steps):
            batch = pending
            # The host side of the step (dispatch and the feed wait); the
            # kernels' time shows in a torch.profiler trace beside it.
            with tracing.start_span("train.step", step=i + 1):
                self.state, stats = self.step_fn(self.state, batch)
                if i + 1 < steps:
                    with tracing.device_range("train.feed"):
                        t_feed = time.monotonic()
                        nxt = next(data)
                        feed_wait += time.monotonic() - t_feed
                        pending = self.place_batch(nxt)
            if (i + 1) % cfg.log_every == 0 or i + 1 == steps:
                last_loss = float(stats["loss"])  # sync point
                now = time.monotonic()
                n_steps = max(1, i + 1 - last_logged)
                dt = (now - t_prev) / n_steps
                t_prev = now
                last_logged = i + 1
                mfu = fps / dt / peak if peak else 0.0
                record = {
                    "step": i + 1, "loss": last_loss,
                    "grad_norm": float(stats["grad_norm"]),
                    "step_s": dt, "mfu": mfu,
                    "feed_wait_s": feed_wait / n_steps,
                    **{k: float(v) for k, v in stats.items()
                       if k not in ("loss", "grad_norm")},
                }
                self.history.append(record)
                M.TRAIN_STEP_SECONDS.set(dt)
                M.TRAIN_EXAMPLES_PER_SEC.set(cfg.batch_size / dt)
                M.FEED_WAIT_SECONDS.set(record["feed_wait_s"])
                M.TRAIN_MFU.set(mfu)
                if "moe_drop_frac" in record:
                    M.MOE_DROP_FRAC.set(record["moe_drop_frac"])
                log.info("step", **{k: round(v, 4) if isinstance(v, float) else v
                                    for k, v in record.items()})
                feed_wait = 0.0
            if eval_every and (i + 1) % eval_every == 0:
                eval_loss = self.evaluate(eval_data)
                record = {"step": i + 1, "eval_loss": eval_loss,
                          **{f"eval_{k}": v for k, v in self.last_eval_stats.items()
                             if k != "loss"}}
                self.history.append(record)
                log.info("eval", **{k: round(v, 4) if isinstance(v, float) else v
                                    for k, v in record.items()})
                # Eval time stays out of the next step_s (and feed wait
                # with it: both divide by the steps since the last log).
                t_prev = time.monotonic()
                last_logged = i + 1
                feed_wait = 0.0
            if self.checkpointer is not None and cfg.checkpoint_every \
                    and (i + 1) % cfg.checkpoint_every == 0:
                self.checkpointer.save(i + 1, self.state)
                log.info("checkpoint", step=i + 1, dir=cfg.checkpoint_dir)
        if self.checkpointer is not None:
            # The final save; a no-op for a step already on disk (the
            # loop's last one, or a resume at or past ``steps``).
            self.checkpointer.save(self.state.step, self.state, wait=True)
        return last_loss
