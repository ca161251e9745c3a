"""oim-infer for the port (``oim_tpu/cli/oim_infer.py``): KV-cached
generation from a checkpoint of the port's trainer.

It restores the latest step from --checkpoint-dir through
``Trainer.init_or_resume``, decodes with ``models/generate.py`` and prints
one comma-separated row of token ids per prompt row. Prompts are raw
token ids (tokenization is outside the framework's scope).

    python -m oim_tpu_torch.cli.oim_infer --checkpoint-dir ckpt \\
        --model llama-tiny-moe --prompt 12,7,90 --n-new 64 --temperature 0.8

``--device`` defaults to ``cuda``. The checkpoint is the port's own
format, so a JAX trainer's (orbax) directory does not restore here. With
no --prompt the prompt is 8 tokens from a ``torch.Generator`` seeded with
--seed; sampling draws from one seeded the same way.
"""

from __future__ import annotations

import argparse
import sys

import torch

from oim_tpu_torch.common import logging as oimlog
from oim_tpu_torch.train import TrainConfig, Trainer


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("oim-infer (torch)")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--model", default="llama-tiny",
                   choices=("llama-tiny", "llama-tiny-moe", "llama3-8b"))
    p.add_argument("--prompt", default="",
                   help="comma-separated token ids; ';' between rows for a batch")
    p.add_argument("--n-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seq", type=int, default=0,
                   help="cache length (default: prompt + n-new)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", default="text", choices=("text", "json"))
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    oimlog.set_global(oimlog.Logger(level=oimlog.parse_level(args.log_level),
                                    fmt=args.log_format))
    log = oimlog.from_context()

    from oim_tpu_torch.models import generate as gen

    cfg = TrainConfig(model=args.model, checkpoint_dir=args.checkpoint_dir)
    mcfg = cfg.model_config()
    trainer = Trainer(cfg, device=args.device)
    dev = trainer.device
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    if args.prompt:
        rows = [[int(t) for t in row.split(",") if t.strip()]
                for row in args.prompt.split(";")]
        if any(len(r) != len(rows[0]) for r in rows):
            raise SystemExit("all prompt rows must have the same length")
        prompt = torch.tensor(rows, dtype=torch.int32, device=dev)
        if int(prompt.max()) >= mcfg.vocab:
            raise SystemExit(f"prompt token {int(prompt.max())} >= vocab {mcfg.vocab}")
    else:
        prompt = torch.randint(0, mcfg.vocab, (1, 8), generator=rng, device=dev,
                               dtype=torch.int32)

    # Refused before init_or_resume, which would draw a fresh model.
    if trainer.checkpointer is None or trainer.checkpointer.latest_step() is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir!r} "
                         "(refusing to sample from random init)")
    step = trainer.init_or_resume()
    log.info("restored", step=step, model=args.model)

    out = gen.generate(trainer.state.params, prompt, args.n_new, mcfg,
                       temperature=args.temperature, rng=rng,
                       max_seq=args.max_seq or None)
    for row in out.tolist():
        print(",".join(str(t) for t in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
