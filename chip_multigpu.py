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
zigzag`` (one row of 4096), each run's every step against one rank on
the same global batch and initial params (run here on cuda:0 before the
ranks start), its replicas equal to the bit and, under fsdp, 1/N of the
unsharded parameter bytes a rank; then the planted faults, each of which
must break a limit. It fails on any miss, prints per-rank
step_s and peak memory and the collectives' calls and bytes, a
``multigpu`` JSON line, the cards' names and power limits, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    cs.say(f"== NCCL, {n} ranks, one card a rank")
    ranks = cs.run_ranks(cs.ranks_job, n, "nccl", RANK_TIMEOUT, None)
    out = cs.check_ranks(ranks, n, single, "nccl")
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
