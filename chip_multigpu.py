"""Multi-card check of the port's multi-rank path: NCCL across the cards of
one host, one rank a card.

    python3 chip_multigpu.py       # every card of the host (two or more)

``chip_smoke.py`` checks this path with two ranks sharing one card over
gloo, because the machine it runs on holds one card. Here each rank has
its own card (``cuda:<rank>``) and NCCL carries every collective. After
building the kernels it runs chip_smoke's phase-15 checks at world size
N, the number of cards: each collective of ``parallel/collectives.py``
on CUDA tensors against its value; ring, zigzag and Ulysses attention at
llama3-8b's width (q [1,4096,32,128], k/v [1,4096,8,128], bf16, causal)
over a seq axis of N against the plain versions of K1-K3 on one rank, with
K1-K3 launches equal to the schedule's, all on ``wgmma``; the trainer
CLI at llama3-8b width (2 layers, 4 steps) under ``--rules dp --mesh
data=N``, ``--rules fsdp --mesh data=1,fsdp=N`` (a batch of N rows) and
``--rules tp_sp --mesh data=1,fsdp=1,seq=N,model=1 --seq-parallel
zigzag`` (one row of 4096), tensor parallelism ``--mesh
data=1,fsdp=1,seq=1,model=N`` (the same row; its collectives equal to
``tp_collectives``' count) and, on four cards, ``seq=2,model=2`` with
zigzag, each run's every step against one rank on the same global batch
and initial params (run here on cuda:0 before the ranks start), its
replicas equal to the bit and, under fsdp and tensor parallelism, 1/N of
the split leaves' bytes a rank; then the planted faults, each of which
must break a limit. Then MoE and ResNet across the cards: the MoE
flagship at full width and depth under ``--rules tp_sp --mesh
data=1,fsdp=1,seq=1,model=1,expert=N`` (each card its share of the
experts; collectives equal to ``ep_collectives``' count, moe_drop_frac
within one assignment of one rank's) and ResNet-50 at bench.py's cell
under ``--rules dp --mesh data=N`` (its BN running statistics against one
rank's), each against one rank on cuda:0 at every step within
PAR_LOSS_REL / PAR_NORM_REL (ResNet within its own, chip_smoke's
RESNET_PAR_*). Last, tensor-parallel serving with its members on
distinct cards: llama3-8b at full depth, phase 7's 12 requests on one
card (shard 1), then ``ServeEngine(shard=2, devices=["cuda:0",
"cuda:1"])`` with chip_smoke's sharded checks: the member-memory gate,
the members' weight bytes, every replayed request ending by length and
its agreement with shard 1's stream reported, one allreduce per target
dispatch, shard 1's greedy streams teacher-forced through the paged
prefill, decode and verify of both (every generated position's logits
within SERVE_LOGIT_REL x max|logit| of shard 1's), and the decode step
at shard 1 and 2. It fails on any miss, prints per-rank step_s and peak memory
and the collectives' calls and bytes, a ``multigpu`` JSON line, the
cards' names and power limits, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RANK_TIMEOUT = 900  # seconds the ranks' job may take


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this check runs on CUDA cards only",
              flush=True)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
        from oim_tpu_torch import kernels
    except ImportError as e:
        print(f"FAIL: chip_smoke.py and the port are not beside this script ({e})", flush=True)
        return 3
    n = torch.cuda.device_count()
    if n < 2:
        cs.fail(f"{n} card(s): this check needs two or more")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    cs.say(f"== {n} cards: {cards}; torch {torch.__version__} CUDA {torch.version.cuda}")
    cs.say(f"  built {kernels.build()} (s per kernel)")
    cs.say("== one rank on cuda:0: each run's history")
    single = cs.one_rank_references(n, "cuda:0")
    refs12 = cs.slice12_references("cuda:0", None, full=False)
    cs.say(f"== NCCL, {n} ranks, one card a rank")
    root = tempfile.mkdtemp(prefix="oim-multigpu-")
    try:
        ranks = cs.run_ranks(functools.partial(cs.ranks_job, root=root, full=False), n, "nccl",
                             RANK_TIMEOUT, None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = cs.check_ranks(ranks, n, single, "nccl")
    cs.say(f"== MoE (expert={n}) and ResNet-50 (data={n}) across the cards")
    out["train"].update(cs.check_slice12(ranks, refs12, None)[0])
    cs.say("== tensor-parallel serving, members on cuda:0 and cuda:1")
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import ServeEngine

    cfg = llama.LLAMA3_8B
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    eng = ServeEngine(params, cfg, device="cuda", **cs.SERVE_ENGINE)
    streams = cs.replay_streams(eng, cs.serve_traffic(cfg.vocab))
    eng.stop(drain=True)
    del eng
    out["serve_sharded"] = cs.phase_serve_sharded(cfg, params, streams,
                                                  devices=("cuda:0", "cuda:1"))
    del params
    cs.say(f"  total {time.monotonic() - t0:.1f} s")
    cs.say(json.dumps({"multigpu": {"world": n, **out}, "cards": cards}))
    for card in cards:
        cs.say(card)
    cs.say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
