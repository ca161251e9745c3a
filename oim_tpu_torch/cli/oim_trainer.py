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
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m oim_tpu_torch.cli.oim_trainer --model llama3-8b --override n_layers=4 \\
        --rules pipe --mesh data=1,pipe=2 --pipeline-schedule 1f1b \\
        --microbatches 4 --steps 4 --batch-size 4 --seq-len 2048

``--device`` defaults to ``cuda``; ``--device cpu`` runs the same step
with the kernels' plain versions. ``--metrics-port`` serves the trainer's
gauges at ``/metrics`` and its ``train.step`` spans at ``/debug/spans``;
``--trace-dir`` streams the spans to ``oim-trainer-<pid>.trace.json``. Checkpoints are the port's own format,
not orbax's: the JAX trainer cannot resume from them, nor this one from
the JAX trainer's.

Fed through the control plane: ``--registry`` with ``--controller-id``
publishes ``--volume`` through the feeder, MapVolume through the
registry's proxy to the controller, and trains on it: a file
(``--volume-file``), webdataset shards (``--volume-webdataset``: int32
tokens under ``--wds-ext`` for a llama model, jpg/cls samples for
ResNet), labeled TFRecords (``--volume-tfrecord``, ResNet; ``--label-offset
-1`` for 1-based labels), or the controller's malloc buffer of that name.
It trains in windows of ``--feed-window-bytes`` (64 MiB by default; a
shard at a time for webdataset; ``--shuffle`` then runs the records
through a reservoir of ``--shuffle-buffer-records``), or on the volume
read whole with ``--feed-window-bytes 0`` (``--shuffle`` permutes each
epoch, and ``--checkpoint-dir`` resumes by seeking the feed).
``--eval-volume-file``, ``--eval-volume-tfrecord`` and
``--eval-volume-webdataset`` name the held-out volume of ``--eval-every``.
A volume is staged by the controller, so its paths are the controller's:

    python -m oim_tpu_torch.cli.oim_trainer --registry 127.0.0.1:9421 \
        --controller-id host-0 --volume-file /data/tokens.npy \
        --model llama3-8b --override n_layers=2 --steps 5 --batch-size 2 --seq-len 2048

With ``--registry`` and ``--metrics-port`` the trainer publishes its
``telemetry/<id>`` row (``--telemetry-id``, default
``<controller-id>.trainer``). ``--smoke`` is the JAX CLI's: llama-tiny, at
most 5 steps of batch 2 and 32 tokens, logged every step, on ``data=`` the
smaller of the batch and the ranks; ``--synthetic`` names the default
source.

Ranks assembled from the registry: with ``--registry`` and
``--expected-hosts N`` (N > 1) each process waits until N controllers
are registered, takes its rank from their mesh coordinates (ties by id:
``parallel/bootstrap.py``) and joins the process group with rank 0's
host at ``--coordinator-port``. Under torchrun (one process a card) the
host's ``LOCAL_WORLD_SIZE`` processes take consecutive ranks after their
host's, each on ``cuda:LOCAL_RANK``; alone, a process is its host's one
rank, on ``cuda:0``.

Several ranks: under ``torchrun`` (``WORLD_SIZE`` set) each process joins
the process group from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``; NCCL when each rank has its own card,
gloo otherwise) and trains on ``cuda:LOCAL_RANK``; ``--rules``, ``--mesh``
and ``--seq-parallel`` are the JAX trainer's (``--mesh ...,expert=N``
splits an MoE model's experts under ``--rules tp_sp``), and so are
``--microbatches``, ``--pipeline-schedule`` and ``--virtual-stages`` under
``--rules pipe`` (``--mesh data=1,pipe=2``). Without
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

from oim_tpu_torch.cli.common import (
    add_observability_flags,
    add_registry_flag,
    load_tls_flags,
    start_observability,
    start_telemetry_row,
)
from oim_tpu_torch.common import logging as oimlog
from oim_tpu_torch.common.profiling import profile_trace
from oim_tpu_torch.data.augment import augment_batches
from oim_tpu_torch.data.feeds import (
    SeekableFeed,
    eval_feed_args,
    feeder_batches,
    refuse_tfrecord_for_llama,
)
from oim_tpu_torch.data.prefetch import prefetch_batches
from oim_tpu_torch.data.shuffle import shuffle_batches
from oim_tpu_torch.parallel.mesh import backend_for, parse_axes
from oim_tpu_torch.train import TrainConfig, Trainer
from oim_tpu_torch.train.trainer import synthetic_batches

# The JAX CLI's augmentation seed on process 0:
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
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatch count (--rules pipe)")
    p.add_argument("--pipeline-schedule", default="gpipe", choices=("gpipe", "1f1b"),
                   help="1f1b bounds live activations by the pipe depth instead of the "
                        "microbatch count (needs microbatches %% pipe == 0; both "
                        "schedules serve MoE and seq-in-pipe)")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="interleaved 1F1B: virtual stages (layer chunks) per rank; "
                        "bubble (P-1)/(v*M+P-1); needs --pipeline-schedule 1f1b and "
                        "n_layers %% (pipe*v) == 0")
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
    p.add_argument("--label-offset", type=int, default=0,
                   help="added to every fed label before the range check "
                        "(-1 for 1-based ImageNet-convention records)")
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
    p.add_argument("--smoke", action="store_true",
                   help="tiny model, 5 steps, CPU-friendly")
    # Data source (feeder mode).
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="train on synthetic batches (the default without --registry)")
    add_registry_flag(p, help_suffix="feeder data source")
    p.add_argument("--controller-id", default="")
    p.add_argument("--volume", default="train-data")
    p.add_argument("--volume-file", default="",
                   help="stage this file (on the controller's host) as the training volume")
    p.add_argument("--volume-tfrecord", default="",
                   help="comma-separated TFRecord paths (serialized tf.Examples: "
                        "image/encoded + image/class/label) staged as a labeled "
                        "image volume")
    p.add_argument("--volume-webdataset", default="",
                   help="comma-separated webdataset shard URLs (local paths or "
                        "http(s)) to stage and train on")
    p.add_argument("--wds-ext", default="bin",
                   help="sample extension holding int32 tokens")
    p.add_argument("--eval-volume-file", default="",
                   help="held-out volume staged as '<volume>-eval' and used for "
                        "--eval-every in feeder mode")
    p.add_argument("--eval-volume-tfrecord", default="",
                   help="held-out labeled TFRecord volume (tf.Examples) for "
                        "--eval-every in feeder mode")
    p.add_argument("--eval-volume-webdataset", default="",
                   help="held-out webdataset shard list staged as '<volume>-eval' "
                        "for --eval-every: token shards for llama models "
                        "(--wds-ext), jpg/cls shards for vision")
    p.add_argument("--shuffle", action="store_true",
                   help="shuffle records: whole-volume feeds permute per epoch; "
                        "windowed feeds run through a bounded reservoir "
                        "(--shuffle-buffer-records)")
    p.add_argument("--shuffle-buffer-records", type=int, default=2048,
                   help="reservoir size (records) for shuffling windowed feeds")
    p.add_argument("--shuffle-seed", type=int, default=0)
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="feed batches read ahead in a background thread "
                        "(0 = synchronous feed)")
    p.add_argument("--feed-window-bytes", type=int, default=64 << 20,
                   help="host-resident feed window; 0 = read the whole volume "
                        "(small volumes only)")
    p.add_argument("--publish-timeout", type=float, default=60.0)
    p.add_argument("--no-direct-data", dest="direct_data", action="store_false",
                   help="stream feed windows through the registry proxy instead of "
                        "dialing the owning controller directly (the proxy always "
                        "remains the fallback)")
    p.add_argument("--ca", default="", help="CA certificate file (mTLS)")
    p.add_argument("--key", default="",
                   help="path prefix for <prefix>.key/.crt (mTLS)")
    p.add_argument("--expected-hosts", type=int, default=1,
                   help="several hosts: wait for this many controllers in the registry, "
                        "take this process's rank from their coordinates and join the "
                        "process group")
    p.add_argument("--coordinator-port", type=int, default=8476,
                   help="port of the process group's rendezvous on the rank-0 host "
                        "(whose address the registry gives)")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the train loop into "
                        "this directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", default="text", choices=("text", "json"))
    add_observability_flags(p)
    args = p.parse_args(argv)
    if args.smoke:
        args.model = "llama-tiny"
        args.steps = min(args.steps, 5)
        args.batch_size = min(args.batch_size, 2)
        args.seq_len = min(args.seq_len, 32)
        args.log_every = 1
        if not args.mesh:
            ranks = int(os.environ.get("WORLD_SIZE", "1"))
            args.mesh = f"data={min(args.batch_size, ranks)}"
    return args


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
        microbatches=args.microbatches, pipeline_schedule=args.pipeline_schedule,
        virtual_stages=args.virtual_stages,
        remat=args.remat, remat_policy=args.remat_policy,
        accum_steps=args.accum_steps, batch_size=args.batch_size, seq_len=args.seq_len,
        image_size=args.image_size, num_classes=args.num_classes,
        label_offset=args.label_offset, lr=args.lr,
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


def join(args: argparse.Namespace) -> tuple[str, bool]:
    """Join the process group the run asks for: assembled from the
    registry under ``--expected-hosts > 1`` (torchrun's ``LOCAL_RANK`` of
    ``LOCAL_WORLD_SIZE`` processes on each host; ``cuda`` becomes
    ``cuda:LOCAL_RANK``), else torchrun's (``init_distributed``).
    Returns (this rank's device, whether this call made the group)."""
    if not (args.registry and args.expected_hosts > 1):
        return init_distributed(args.device)
    from oim_tpu_torch.parallel.bootstrap import initialize_from_registry

    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = f"cuda:{local_rank}" if args.device == "cuda" else args.device
    made = not dist.is_initialized()
    rank, world = initialize_from_registry(
        args.registry, args.controller_id, args.expected_hosts, load_tls_flags(args),
        coordinator_port=args.coordinator_port, device=device, local_rank=local_rank,
        local_ranks=int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    oimlog.from_context().info("distributed", process_id=rank, num_processes=world)
    return device, made and dist.is_initialized()


def run(argv: list[str] | None = None) -> Trainer:
    """Parse flags, build the Trainer, run it; returns the Trainer (its
    ``history`` holds every logged step and eval pass)."""
    args = parse_args(argv)
    oimlog.set_global(oimlog.Logger(level=oimlog.parse_level(args.log_level),
                                    fmt=args.log_format))
    axes = parse_mesh(args.mesh)
    if args.registry:
        check_fed_args(args)
        refuse_tfrecord_for_llama(args, config_from_args(args))
    device, made_group = join(args)
    obs = start_observability(args, "oim-trainer")
    if args.registry:
        start_telemetry_row(
            obs, args.telemetry_id or (f"{args.controller_id}.trainer"
                                       if args.controller_id else ""),
            "trainer", args.registry, tls=load_tls_flags(args))
    feeder = None
    try:
        cfg = config_from_args(args)
        trainer = Trainer(cfg, device=device, axes=axes)
        data = eval_data = None
        if args.registry:
            data, eval_data, feeder = fed_data(args, cfg)
        if args.augment:
            if args.eval_every and data is None:
                # The augmented stream is no longer the Trainer's own
                # default, so the held-out stream is built here, as run()
                # would.
                eval_data = synthetic_batches(
                    dataclasses.replace(cfg, seed=cfg.seed + 10_000))
            data = augment_batches(data if data is not None else synthetic_batches(cfg),
                                   seed=(args.shuffle_seed + 1) * AUGMENT_SEED)
        if data is not None and args.prefetch_batches > 0 and not hasattr(data, "seek"):
            # Fetch of batch N+1 overlaps the train step on batch N (a
            # SeekableFeed already prefetches inside its factory).
            data = prefetch_batches(data, depth=args.prefetch_batches)
        with profile_trace(args.profile):
            trainer.run(steps=args.steps, data=data, eval_data=eval_data)
    finally:
        if feeder is not None:
            feeder.close()
        obs.stop()
        if made_group:
            dist.destroy_process_group()
    return trainer


def check_fed_args(args: argparse.Namespace) -> None:
    """SystemExit for a --registry run the flags do not make whole, before
    any process group or server starts."""
    if not args.controller_id:
        raise SystemExit("--registry needs --controller-id (the controller that stages "
                         "the volume)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and args.expected_hosts <= 1:
        raise SystemExit(
            "--registry under several ranks needs --expected-hosts: the ranks are "
            "assembled from the registry (parallel/bootstrap.py), one controller a "
            "host; or train the ranks on synthetic batches")


def fed_data(args: argparse.Namespace, cfg: TrainConfig):
    """(training batches, eval batches or None, the Feeder) of the volume
    published through ``--registry``, as the JAX trainer builds them."""
    from oim_tpu_torch.feeder import Feeder

    tls = load_tls_flags(args)
    # One Feeder for every rebuild: its publish cache makes MapVolume a
    # one-time cost (a seek repositions in index space; it must not
    # re-stage the volume).
    feeder = Feeder(registry_address=args.registry, controller_id=args.controller_id,
                    tls=tls, direct_data=args.direct_data)
    if args.feed_window_bytes <= 0 and args.checkpoint_dir and not args.augment:
        # Whole-volume feeds reposition in index arithmetic on checkpoint
        # resume (SeekableFeed.seek) instead of replaying start_step
        # batches. The factory rebuilds the chain including the
        # prefetcher, so a seek also drops batches read ahead of the old
        # position.
        def make_feed(start):
            d = feeder_batches(args, cfg, tls, start, feeder=feeder)
            if args.prefetch_batches > 0:
                d = prefetch_batches(d, depth=args.prefetch_batches)
            return d

        data = SeekableFeed(make_feed)
    else:
        data = feeder_batches(args, cfg, tls, feeder=feeder)
    if args.shuffle and args.feed_window_bytes > 0:
        # Windowed feeds stream in volume order; a bounded record
        # reservoir restores sample randomness with fixed host memory.
        data = shuffle_batches(data, args.shuffle_buffer_records, seed=args.shuffle_seed)
    eval_data = None
    if args.eval_every:
        eval_args = eval_feed_args(args)
        if eval_args is not None:
            eval_data = feeder_batches(eval_args, cfg, tls, feeder=feeder)
    return data, eval_data, feeder


def main(argv: list[str] | None = None) -> int:
    trainer = run(argv)
    losses = [r["loss"] for r in trainer.history if "loss" in r]
    oimlog.from_context().info("done", steps=trainer.state.step,
                               loss=losses[-1] if losses else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
