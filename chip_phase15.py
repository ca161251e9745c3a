"""Phase 15's MoE, ResNet and checkpoint runs of ``chip_smoke.py`` alone,
or its pipeline runs alone, on one NVIDIA H100: a quicker loop than the
whole script while that part changes.

    python3 chip_phase15.py            # MoE, ResNet, checkpoints
    python3 chip_phase15.py --pipe     # pipeline parallelism
    python3 chip_phase15.py --slice14  # a volume across the mesh; a head split

It builds the kernels, runs phase 11 (the MoE flagship trained 4 steps:
the one-rank reference of run (a)), then chip_smoke's ``slice12_job`` on
two gloo ranks sharing the card, the one-rank references of (b) and (c),
the one-process resumes of (d), and ``check_slice12``'s gates. Unlike
chip_smoke.py it reports every gate it misses and goes on; it exits
nonzero if any was missed. The last lines are a ``slice12`` JSON line and
the card's name and power limit.

With ``--pipe`` it builds the kernels and runs chip_smoke's pipe runs
instead: the one-rank references (``pipe_references``), ``pipe_job`` on
two gloo ranks sharing the card ((e)-(h), the memory readings and
PIPE_FAULTS) and ``check_pipe``'s gates; its JSON line is ``pipe``.

With ``--slice14`` it runs (i) and (j): the one-rank references (phase
5's config for (i), ``slice14_references`` for (j)), the volumes
(``slice14_volumes``), ``slice14_job`` on two gloo ranks sharing the card
and ``check_slice14``'s gates (phase 8 is not run: its stage is printed
as nan); its JSON line is ``slice14``.
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


def pipe_job(rank: int, world: int, device: str) -> dict:
    import chip_smoke as cs

    return {"pipe": cs.pipe_job(rank, world, device)}


def slice14_job(rank: int, world: int, device: str, volumes: dict) -> dict:
    import chip_smoke as cs

    return {"slice14": cs.slice14_job(rank, world, device, volumes)}


def slice14_main(cs, missed: list, t0: float, card: str) -> int:
    from oim_tpu_torch.cli import oim_trainer

    hist = oim_trainer.run(cs.run_argv([], cs.BATCH, cs.SEQ, "cuda:0")).history
    main = {"history": hist, "losses": [h["loss"] for h in hist]}
    refs = cs.slice14_references("cuda:0")
    root = tempfile.mkdtemp(prefix="oim-placed-")
    try:
        volumes = cs.slice14_volumes(root)
        ranks = cs.run_ranks(functools.partial(slice14_job, volumes=volumes), cs.PAR_WORLD,
                             "gloo", cs.PAR_RANK_TIMEOUT, "cuda:0")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nan = float("nan")
    out, faults = cs.check_slice14(ranks, main, refs, {"stage_gbps": nan, "stage_s": nan,
                                                       "volume_bytes": 0})
    cs.say(f"  total {time.monotonic() - t0:.1f} s; {len(missed)} gate(s) missed")
    cs.say(json.dumps({"slice14": out, "faults": faults, "missed": missed}))
    cs.say(card)
    return 1 if missed else 0


def pipe_main(cs, missed: list, t0: float, card: str) -> int:
    refs = cs.pipe_references("cuda:0", cs.PAR_WORLD)
    ranks = cs.run_ranks(pipe_job, cs.PAR_WORLD, "gloo", cs.PAR_RANK_TIMEOUT, "cuda:0")
    out, faults, memory = cs.check_pipe(ranks, refs, cs.PAR_WORLD)
    cs.say(f"  total {time.monotonic() - t0:.1f} s; {len(missed)} gate(s) missed")
    cs.say(json.dumps({"pipe": out, "faults": faults, "memory_gb": memory, "missed": missed}))
    cs.say(card)
    return 1 if missed else 0


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
    if "--pipe" in sys.argv[1:]:
        return pipe_main(cs, missed, t0, card)
    if "--slice14" in sys.argv[1:]:
        return slice14_main(cs, missed, t0, card)
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
