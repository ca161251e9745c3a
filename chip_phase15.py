"""Phase 15's MoE, ResNet and checkpoint runs of ``chip_smoke.py`` alone,
on one NVIDIA H100: a quicker loop than the whole script while that part
changes.

    python3 chip_phase15.py

It builds the kernels, runs phase 11 (the MoE flagship trained 4 steps:
the one-rank reference of run (a)), then chip_smoke's ``slice12_job`` on
two gloo ranks sharing the card, the one-rank references of (b) and (c),
the one-process resumes of (d), and ``check_slice12``'s gates. Unlike
chip_smoke.py it reports every gate it misses and goes on; it exits
nonzero if any was missed. The last lines are a ``slice12`` JSON line and
the card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def job(rank: int, world: int, device: str, root: str) -> dict:
    import chip_smoke as cs

    return {"slice12": cs.slice12_job(rank, world, device, root)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this check runs on a CUDA card only",
              flush=True)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from oim_tpu_torch import kernels

    missed = []

    def note(msg: str, code: int = 1) -> None:
        missed.append(msg)
        cs.say(f"FAIL: {msg}")

    cs.fail = note
    t0 = time.monotonic()
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.say(f"  built {kernels.build()}")
    moe_history = cs.phase_moe_main(False).pop("history")
    torch.cuda.empty_cache()
    refs = cs.slice12_references("cuda:0", moe_history)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="oim-ckpt-")
    try:
        ranks = cs.run_ranks(functools.partial(job, root=root), cs.PAR_WORLD, "gloo",
                             cs.PAR_RANK_TIMEOUT, "cuda:0")
        resumes = {"moe_fsdp": cs._resume_one_rank("moe_fsdp", f"{root}/one", "cuda:0"),
                   "ep": cs._resume_one_rank("ep", f"{root}/ep_one", "cuda:0")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out, faults = cs.check_slice12(ranks, refs, resumes)
    cs.say(f"  total {time.monotonic() - t0:.1f} s; {len(missed)} gate(s) missed")
    cs.say(json.dumps({"slice12": out, "faults": faults, "missed": missed}))
    cs.say(card)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
