"""The trainer (``oim_tpu/train/trainer.py``): a single-device train step
and the loop that logs loss, grad_norm, step_s and mfu.

Ported so far: ``TrainConfig`` for the llama models, ``make_train_step``
with rules "dp" on one device and gradient accumulation,
``synthetic_batches`` (the same numpy stream as the JAX package),
``flops_per_step``, ``peak_flops_per_device`` (keyed on the CUDA device
name) and ``Trainer.run``. Checkpointing, meshes, remat, evaluation and
profiling are not ported yet, and ``TrainConfig`` has no fields for them.

PyTorch runs eagerly, so the step is a plain function: forward, backward
through ``torch.autograd.grad``, then the optimizer's in-place update.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.models import llama
from oim_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    tree_leaves,
    tree_unflatten,
)

# Peak dense bf16 FLOP/s per device for MFU accounting, matched against
# torch.cuda.get_device_name() in order (NVIDIA data sheets; the PCIe
# H100 before the SXM part, whose name it contains).
PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
    ("h200", 989e12),
)


def peak_flops_per_device(device="cuda") -> float:
    """Peak bf16 FLOP/s of ``device``; 0.0 for a CPU or an unknown card."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device).lower()
    for key, val in PEAK_FLOPS:
        if key in name:
            return val
    return 0.0


@dataclasses.dataclass
class TrainConfig:
    model: str = "llama-tiny"  # llama-tiny | llama3-8b
    rules: str = "dp"  # only "dp" on one device is ported
    accum_steps: int = 1  # gradient accumulation: split the batch, one update
    batch_size: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    log_every: int = 10
    seed: int = 0
    # dataclasses.replace overrides applied to the named model's config
    # (e.g. a tiny-depth llama3-8b for dryruns: full vocab, 2 layers).
    model_overrides: dict = dataclasses.field(default_factory=dict)

    def model_config(self) -> llama.Config:
        if self.model == "llama-tiny":
            mcfg = llama.tiny()
        elif self.model == "llama3-8b":
            mcfg = llama.LLAMA3_8B
        else:
            raise ValueError(f"unknown model {self.model!r} (ported: llama-tiny, llama3-8b)")
        if self.model_overrides:
            mcfg = dataclasses.replace(mcfg, **self.model_overrides)
        return mcfg

    def check_supported(self) -> None:
        if self.rules != "dp":
            raise NotImplementedError(f"rules {self.rules!r}: only 'dp' is ported")
        llama.check_supported(self.model_config())


def make_train_step(cfg: TrainConfig, tx, device) -> tuple[Callable, Callable]:
    """Returns (step_fn, init_fn).

    ``init_fn(rng, params=None)`` builds the TrainState: params drawn from
    the torch.Generator ``rng`` on ``device``, or the given params.
    ``step_fn(state, batch)`` runs one update in place and returns
    (state, stats) with stats["loss"] and stats["grad_norm"] as f32
    scalars on the device.
    """
    cfg.check_supported()
    mcfg = cfg.model_config()
    accum = max(1, cfg.accum_steps)

    def init_fn(rng: torch.Generator | None, params=None) -> TrainState:
        if params is None:
            params = llama.init(rng, mcfg, device=device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return TrainState(step=0, params=params, opt_state=tx.init(params))

    def grads_of(params, tokens):
        leaves = list(tree_leaves(params))
        loss, stats = llama.loss_and_stats(params, tokens, mcfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), stats, grads

    def step_fn(state: TrainState, batch: dict):
        tokens = batch["tokens"]
        leaves = list(tree_leaves(state.params))
        if accum == 1:
            loss, stats, grads = grads_of(state.params, tokens)
        else:
            if tokens.shape[0] % accum:
                raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                                 f"accum_steps {accum}")
            # Accumulate in f32 (a bf16 accumulator drops low bits every
            # add), average, cast back to the param dtype.
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in leaves]
            loss_sum = 0.0
            stats_sum: dict = {}
            for mb in tokens.chunk(accum):
                loss, mstats, grads = grads_of(state.params, mb)
                for a, g in zip(gsum, grads):
                    a += g.float()
                loss_sum = loss_sum + loss
                for k, v in mstats.items():
                    stats_sum[k] = stats_sum.get(k, 0.0) + v.detach()
            grads = [(a / accum).to(p.dtype) for a, p in zip(gsum, leaves)]
            loss = loss_sum / accum
            stats = {k: v / accum for k, v in stats_sum.items()}
        grad_tree = tree_unflatten(state.params, grads)
        grad_norm = tx.update(grad_tree, state.opt_state, state.params)
        state.step += 1
        return state, {
            "loss": loss.float(),
            "grad_norm": grad_norm,
            **{k: v.detach().float() for k, v in stats.items()},
        }

    return step_fn, init_fn


def synthetic_batches(cfg: TrainConfig) -> Iterator[dict]:
    """Deterministic host-side batches: the JAX package's numpy stream."""
    rng = np.random.RandomState(cfg.seed)
    mcfg = cfg.model_config()
    while True:
        yield {"tokens": rng.randint(
            0, mcfg.vocab, (cfg.batch_size, cfg.seq_len + 1)).astype(np.int32)}


def flops_per_step(cfg: TrainConfig) -> float:
    mcfg = cfg.model_config()
    return llama.num_flops_per_token(mcfg, cfg.seq_len) * cfg.batch_size * cfg.seq_len


class Trainer:
    """Owns the state and the step; run() drives the loop and logs."""

    def __init__(self, cfg: TrainConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        self.tx = make_optimizer(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                                 total_steps=cfg.total_steps,
                                 weight_decay=cfg.weight_decay)
        self.step_fn, self.init_fn = make_train_step(cfg, self.tx, self.device)
        self.state: TrainState | None = None
        # One record per logged step: step, loss, grad_norm, step_s, mfu.
        self.history: list[dict] = []

    def init(self, params=None) -> None:
        """Fresh state from cfg.seed, or from the given params tree."""
        rng = None
        if params is None:
            rng = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.state = self.init_fn(rng, params)

    def place_batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, steps: int | None = None, data: Iterator[dict] | None = None) -> float:
        log = from_context()
        cfg = self.cfg
        steps = steps or cfg.total_steps
        if data is None:
            data = synthetic_batches(cfg)
        if self.state is None:
            self.init()
        start_step = self.state.step
        fps = flops_per_step(cfg)
        peak = peak_flops_per_device(self.device)
        last_loss = float("nan")
        self._sync()
        t_prev = time.monotonic()
        last_logged = start_step
        # The next batch is placed while the current step's kernels run.
        pending = self.place_batch(next(data)) if start_step < steps else None
        feed_wait = 0.0
        for i in range(start_step, steps):
            batch = pending
            self.state, stats = self.step_fn(self.state, batch)
            if i + 1 < steps:
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
                log.info("step", **{k: round(v, 4) if isinstance(v, float) else v
                                    for k, v in record.items()})
                feed_wait = 0.0
        return last_loss
