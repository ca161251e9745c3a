"""oim-trainer for the port: llama (dense or MoE) or ResNet-50 training
on synthetic batches, on one CUDA device (``oim_tpu/cli/oim_trainer.py``'s
synthetic path), with evaluation, checkpoint/resume, remat and a profiler
trace. The second example is the MoE flagship at full width (1.85e9
parameters, 1.04e9 active).

    python -m oim_tpu_torch.cli.oim_trainer --model llama3-8b \\
        --override n_layers=2 --steps 5 --batch-size 2 --seq-len 2048
    python -m oim_tpu_torch.cli.oim_trainer --model llama3-8b \\
        --override vocab=32768 --override dim=2048 --override n_layers=8 \\
        --override n_heads=16 --override mlp_dim=8192 --override n_experts=4 \\
        --override vocab_chunk=0 --steps 4 --batch-size 2 --seq-len 2048
    python -m oim_tpu_torch.cli.oim_trainer --model resnet50 --steps 20 \\
        --batch-size 128 --checkpoint-dir ckpt --checkpoint-every 10 \\
        --eval-every 10 --eval-steps 2
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m oim_tpu_torch.cli.oim_trainer --model llama3-8b --override n_layers=2 \\
        --rules fsdp --mesh data=1,fsdp=4 --steps 5 --batch-size 4 --seq-len 2048
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m oim_tpu_torch.cli.oim_trainer --model llama-tiny-moe --rules tp_sp \\
        --mesh data=1,fsdp=1,seq=1,model=1,expert=2 --checkpoint-dir ckpt \\
        --checkpoint-every 2 --steps 4

``--device`` defaults to ``cuda``; ``--device cpu`` runs the same step
with the kernels' plain versions. ``--metrics-port`` serves the trainer's
gauges at ``/metrics`` and its ``train.step`` spans at ``/debug/spans``;
``--trace-dir`` streams the spans to ``oim-trainer-<pid>.trace.json``. Checkpoints are the port's own format,
not orbax's: the JAX trainer cannot resume from them, nor this one from
the JAX trainer's. The feeder, registry and volume flags (the OIM-fed
feed) and webdataset input are not ported yet.

Several ranks: under ``torchrun`` (``WORLD_SIZE`` set) each process joins
the process group from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``; NCCL when each rank has its own card,
gloo otherwise) and trains on ``cuda:LOCAL_RANK``; ``--rules``, ``--mesh``
and ``--seq-parallel`` are the JAX trainer's (``--mesh ...,expert=N``
splits an MoE model's experts under ``--rules tp_sp``). Without
``WORLD_SIZE`` it is one process with no group. ``--checkpoint-dir`` works
under a mesh too: each rank writes its pieces, and a restart resumes from
them under whatever ``--mesh`` (or number of processes) it names.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from oim_tpu_torch.cli.common import add_observability_flags, start_observability
from oim_tpu_torch.common import logging as oimlog
from oim_tpu_torch.common.profiling import profile_trace
from oim_tpu_torch.data.augment import augment_batches
from oim_tpu_torch.parallel.mesh import backend_for, parse_axes
from oim_tpu_torch.train import TrainConfig, Trainer
from oim_tpu_torch.train.trainer import synthetic_batches

# The JAX CLI's augmentation seed for shuffle seed 0 on process 0:
# (shuffle_seed + 1) * 1_000_003 + process_index.
AUGMENT_SEED = 1_000_003


def _parse_value(val: str):
    low = val.lower()
    if low in ("true", "false"):
        # A string "false" would be truthy in a bool field.
        return low == "true"
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    return val


def parse_mesh(spec: str):
    """'data=4,model=2' -> [("data", 4), ("model", 2)]."""
    try:
        return parse_axes(spec)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}") from e


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("oim-trainer (torch)")
    p.add_argument("--model", default="llama-tiny",
                   choices=("llama-tiny", "llama-tiny-moe", "llama3-8b", "resnet50"))
    p.add_argument("--rules", default="dp", choices=("dp", "fsdp", "tp_sp", "pipe"))
    p.add_argument("--seq-parallel", default="ring", choices=("ring", "zigzag", "ulysses"),
                   help="zigzag = load-balanced causal ring (rules=tp_sp only)")
    p.add_argument("--mesh", default="", help="e.g. data=4,model=2")
    p.add_argument("--override", "--model-override", dest="override", action="append",
                   default=[], metavar="KEY=VALUE",
                   help="override a model-config field (repeatable), e.g. "
                        "--override n_layers=2; ints/floats/booleans parsed, "
                        "dtype=float32 names a torch dtype")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in the backward pass "
                        "(fit bigger models/batches in memory)")
    p.add_argument("--remat-policy", default="",
                   choices=("", "dots", "dots_with_no_batch_dims", "nothing"),
                   help="what remat may SAVE: 'dots' keeps matmul outputs and "
                        "recomputes only elementwise work (llama only)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation microbatches per update")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run a forward-only eval pass every N steps on a "
                        "held-out synthetic stream")
    p.add_argument("--eval-steps", type=int, default=8, help="batches per eval pass")
    p.add_argument("--augment", action="store_true",
                   help="host-side random flip + crop on image batches")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the train loop into "
                        "this directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", default="text", choices=("text", "json"))
    add_observability_flags(p)
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {}
    for item in args.override:
        key, sep, val = item.partition("=")
        if not sep or not key:
            raise SystemExit(f"--override {item!r}: expected KEY=VALUE")
        if key == "dtype":
            dtype = getattr(torch, val, None)
            if not isinstance(dtype, torch.dtype):
                raise SystemExit(f"--override {item!r}: {val!r} is not a torch dtype")
            overrides[key] = dtype
        else:
            overrides[key] = _parse_value(val)
    return TrainConfig(
        model=args.model, rules=args.rules, seq_parallel=args.seq_parallel,
        remat=args.remat, remat_policy=args.remat_policy,
        accum_steps=args.accum_steps, batch_size=args.batch_size, seq_len=args.seq_len,
        image_size=args.image_size, num_classes=args.num_classes, lr=args.lr,
        warmup_steps=args.warmup_steps, total_steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        eval_every=args.eval_every, eval_steps=args.eval_steps, seed=args.seed,
        model_overrides=overrides)


def init_distributed(device: str) -> tuple[str, bool]:
    """Join torchrun's process group when ``WORLD_SIZE`` is set and no group
    exists; returns (this rank's device, whether this call made the
    group). ``cuda`` becomes ``cuda:LOCAL_RANK``."""
    if "WORLD_SIZE" not in os.environ:
        return device, False
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if dist.is_initialized():
        return device, False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    dist.init_process_group(backend_for(dev, local), init_method="env://")
    return device, True


def run(argv: list[str] | None = None) -> Trainer:
    """Parse flags, build the Trainer, run it; returns the Trainer (its
    ``history`` holds every logged step and eval pass)."""
    args = parse_args(argv)
    oimlog.set_global(oimlog.Logger(level=oimlog.parse_level(args.log_level),
                                    fmt=args.log_format))
    axes = parse_mesh(args.mesh)
    device, made_group = init_distributed(args.device)
    obs = start_observability(args, "oim-trainer")
    try:
        cfg = config_from_args(args)
        trainer = Trainer(cfg, device=device, axes=axes)
        data = eval_data = None
        if args.augment:
            if args.eval_every:
                # The augmented stream is no longer the Trainer's own
                # default, so the held-out stream is built here, as run()
                # would.
                eval_data = synthetic_batches(
                    dataclasses.replace(cfg, seed=cfg.seed + 10_000))
            data = augment_batches(synthetic_batches(cfg), seed=AUGMENT_SEED)
        with profile_trace(args.profile):
            trainer.run(steps=args.steps, data=data, eval_data=eval_data)
    finally:
        obs.stop()
        if made_group:
            dist.destroy_process_group()
    return trainer


def main(argv: list[str] | None = None) -> int:
    trainer = run(argv)
    losses = [r["loss"] for r in trainer.history if "loss" in r]
    oimlog.from_context().info("done", steps=trainer.state.step,
                               loss=losses[-1] if losses else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
