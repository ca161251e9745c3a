"""oim-trainer for the port: llama training on synthetic batches, on one
CUDA device (``oim_tpu/cli/oim_trainer.py``'s synthetic path).

    python -m oim_tpu_torch.cli.oim_trainer --model llama3-8b \\
        --override n_layers=2 --steps 5 --batch-size 2 --seq-len 2048

``--device`` defaults to ``cuda``; ``--device cpu`` runs the same step
with the kernels' plain versions. The OIM-fed feed, webdataset input,
checkpointing and multi-GPU meshes are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

from oim_tpu_torch.common import logging as oimlog
from oim_tpu_torch.train import TrainConfig, Trainer


def _parse_value(val: str):
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    return val


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("oim-trainer (torch)")
    p.add_argument("--model", default="llama-tiny", choices=("llama-tiny", "llama3-8b"))
    p.add_argument("--override", "--model-override", dest="override", action="append",
                   default=[], metavar="KEY=VALUE",
                   help="override a model-config field (repeatable), e.g. "
                        "--override n_layers=2; ints/floats parsed")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation microbatches per update")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", default="text", choices=("text", "json"))
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {}
    for item in args.override:
        key, sep, val = item.partition("=")
        if not sep or not key:
            raise SystemExit(f"--override {item!r}: expected KEY=VALUE")
        overrides[key] = _parse_value(val)
    return TrainConfig(
        model=args.model, accum_steps=args.accum_steps, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, warmup_steps=args.warmup_steps,
        total_steps=args.steps, log_every=args.log_every, seed=args.seed, model_overrides=overrides)


def run(argv: list[str] | None = None) -> Trainer:
    """Parse flags, build the Trainer, run it; returns the Trainer (its
    ``history`` holds every logged step)."""
    args = parse_args(argv)
    oimlog.set_global(oimlog.Logger(level=oimlog.parse_level(args.log_level),
                                    fmt=args.log_format))
    trainer = Trainer(config_from_args(args), device=args.device)
    trainer.run(steps=args.steps)
    return trainer


def main(argv: list[str] | None = None) -> int:
    trainer = run(argv)
    oimlog.from_context().info("done", steps=trainer.state.step,
                               loss=trainer.history[-1]["loss"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
