"""Checkpoint and resume under a mesh (``train/checkpoint.py``), on gloo
ranks on the CPU (``tests/torch_parallel_worker.py``), f32.

llama-tiny under ``fsdp`` (data=1,fsdp=2) trains 4 steps unbroken, and 2
steps with a checkpoint at step 2, which rank 0 then copies twice. The
step is resumed three ways and trained to step 4: under the same mesh
(steps 3-4 and the final params equal to the unbroken run's to the bit);
on one process with no group (rank 0 alone); under ``dp`` data=2, a mesh
of other axes. llama-tiny-moe under ``tp_sp`` expert=2 (each rank its two
experts) checkpoints at step 2 and resumes on one process. Every resumed
run is held against the JAX Trainer's unbroken 4 steps on the same global
batches (tests/test_torch_parallel_train.py's limits: loss 1e-4
absolute, grad_norm 1e-4 relative, final params 2e-4). A second job
leaves rank 1 after its pieces of step 4 are durable and before its
marker: step 4 is never committed, ``latest_step`` stays 2 and the step-2
state restores whole.
"""

import os

import jax
import numpy as np
import pytest

from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.train.checkpoint import MANIFEST, Checkpointer
from tests.torch_parallel_worker import Job

JOB_TIMEOUT = 300.0
LOSS_TOL, NORM_TOL, PARAM_TOL = 1e-4, 1e-4, 2e-4
COMMON = dict(lr=1e-2, warmup_steps=2, total_steps=10, log_every=1, seed=3, batch_size=4,
              seq_len=16)
FSDP = [("data", 1), ("fsdp", 2)]
EXPERT2 = [("data", 1), ("fsdp", 1), ("seq", 1), ("model", 1), ("expert", 2)]
DENSE = dict(model="llama-tiny", rules="fsdp", **COMMON)
MOE = dict(model="llama-tiny-moe", rules="tp_sp", **COMMON)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax(cfg: dict, axes) -> dict:
    tr = jtrainer.Trainer(jtrainer.TrainConfig(**cfg), axes=axes)
    tr.init_or_resume()
    init = _flat(jax.tree.map(np.asarray, tr.state.params))
    data = jtrainer.synthetic_batches(tr.cfg)
    losses, norms = [], []
    for _ in range(4):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
    return {"init": init, "losses": losses, "norms": norms,
            "final": _flat(jax.tree.map(np.asarray, tr.state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_mesh")
    dirs = {k: str(tmp / k) for k in ("fsdp", "one", "dp", "moe", "moe_one", "killed")}
    want = {"dense": _jax(DENSE, FSDP), "moe": _jax(MOE, EXPERT2)}

    def sc(name, cfg, axes, phase, steps, ckpt=None, **kw):
        cfg = dict(cfg, checkpoint_dir=dirs[ckpt], checkpoint_every=2) if ckpt else cfg
        return {"type": "checkpoint", "name": name, "cfg": cfg, "axes": axes, "phase": phase,
                "steps": steps, **kw}

    dense = {f"params/{k}": v for k, v in want["dense"]["init"].items()}
    moe = {f"params/{k}": v for k, v in want["moe"]["init"].items()}
    main = Job(tmp, 2, dense, [
        sc("unbroken", DENSE, FSDP, "save", 4),
        sc("first", DENSE, FSDP, "save", 2, "fsdp", copies=[dirs["one"], dirs["dp"]]),
        sc("same_mesh", DENSE, FSDP, "resume", 4, "fsdp"),
        sc("one_process", DENSE, FSDP, "resume", 4, "one", one_process=True),
        sc("other_mesh", dict(DENSE, rules="dp"), [("data", 2)], "resume", 4, "dp"),
    ], JOB_TIMEOUT)
    experts = Job(tmp / "moe", 2, moe, [
        sc("moe_first", MOE, EXPERT2, "save", 2, "moe", copies=[dirs["moe_one"]]),
        sc("moe_one_process", MOE, EXPERT2, "resume", 4, "moe_one", one_process=True),
    ], JOB_TIMEOUT)
    killed = Job(tmp / "kill", 2, dense, [
        sc("killed", DENSE, FSDP, "save", 4, "killed", kill_rank=1, kill_step=4),
    ], JOB_TIMEOUT)
    got = main.results()
    got_moe = experts.results()
    with pytest.raises(RuntimeError, match="a rank failed") as err:
        killed.results()
    return dirs, want, got, got_moe, str(err.value)


def _close(r, name, want, first_step):
    steps = list(r[f"{name}/steps"])
    assert steps == list(range(first_step, 5)), steps
    np.testing.assert_allclose(r[f"{name}/losses"], want["losses"][first_step - 1:],
                               atol=LOSS_TOL)
    np.testing.assert_allclose(r[f"{name}/norms"], want["norms"][first_step - 1:],
                               rtol=NORM_TOL)
    for leaf, w in want["final"].items():
        np.testing.assert_allclose(r[f"{name}/final/{leaf}"], w, atol=PARAM_TOL, err_msg=leaf)


def test_the_saved_step_is_written_in_pieces(runs):
    """Each rank wrote its pieces (every leaf of the fsdp tree but the norms
    is split, so both ranks wrote); the manifest names every leaf's global
    shape and pieces; step 2 is the latest."""
    import json

    dirs, want, _, _, _ = runs
    ck = Checkpointer(dirs["fsdp"])
    assert ck.all_steps() == [2, 4]
    with open(os.path.join(dirs["fsdp"], "2", MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["world"] == 2 and manifest["step"] == 2 and manifest["count"] == 2
    members = {p["member"] for leaf in manifest["leaves"].values() for p in leaf["pieces"]}
    assert members == {0, 1}
    for leaf, w in want["dense"]["init"].items():
        entry = manifest["leaves"]["params/" + leaf.replace(".", "/")]
        assert tuple(entry["shape"]) == w.shape
        assert len(entry["pieces"]) == (1 if "norm" in leaf else 2), leaf


def test_resume_under_the_same_mesh_is_bitwise_the_unbroken_run(runs):
    _, _, got, _, _ = runs
    for r in got:
        assert list(r["same_mesh/steps"]) == [3, 4]
        np.testing.assert_array_equal(r["same_mesh/losses"], r["unbroken/losses"][2:])
        np.testing.assert_array_equal(r["same_mesh/norms"], r["unbroken/norms"][2:])
        for key in r:
            if key.startswith("unbroken/final/"):
                np.testing.assert_array_equal(r[key.replace("unbroken", "same_mesh")], r[key])


@pytest.mark.parametrize("name", ["unbroken", "first", "same_mesh", "other_mesh"])
def test_meshed_runs_follow_the_jax_trainer(runs, name):
    _, want, got, _, _ = runs
    first = 3 if name in ("same_mesh", "other_mesh") else 1
    for r in got:
        if name == "first":
            np.testing.assert_allclose(r["first/losses"], want["dense"]["losses"][:2],
                                       atol=LOSS_TOL)
        else:
            _close(r, name, want["dense"], first)


def test_resume_on_one_process_follows_the_jax_trainer(runs):
    _, want, got, _, _ = runs
    _close(got[0], "one_process", want["dense"], 3)
    assert "one_process/steps" not in got[1]


def test_expert_parallel_checkpoint_resumes_on_one_process(runs):
    dirs, want, _, got, _ = runs
    for r in got:
        np.testing.assert_allclose(r["moe_first/losses"], want["moe"]["losses"][:2],
                                   atol=LOSS_TOL)
    _close(got[0], "moe_one_process", want["moe"], 3)
    import json

    with open(os.path.join(dirs["moe"], "2", MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    # each rank wrote its two experts of every expert leaf
    for leaf in ("w_gate", "w_up", "w_down", "router"):
        pieces = leaves[f"params/layers/moe/{leaf}"]["pieces"]
        assert sorted(p["member"] for p in pieces) == [0, 1], leaf


def test_a_rank_lost_before_its_marker_leaves_the_previous_step(runs):
    dirs, want, _, _, err = runs
    assert "rank 1 (exit 9)" in err
    ck = Checkpointer(dirs["killed"])
    assert ck.latest_step() == 2 and ck.all_steps() == [2]
    partial = [n for n in os.listdir(dirs["killed"]) if n.startswith(".tmp-4-")]
    assert len(partial) == 1
    files = set(os.listdir(os.path.join(dirs["killed"], partial[0])))
    assert {"piece-1.pt", "piece-1.json"} <= files and "done-1" not in files
    assert MANIFEST not in files
    state = ck.restore()  # the step-2 state, whole
    assert state.step == 2 and state.opt_state.count == 2
    assert state.params["embed"].shape == want["dense"]["init"]["embed"].shape


def _steps_logged(text: str) -> dict:
    import json

    out = {}
    for line in text.splitlines():
        if line.startswith("{") and '"msg": "step"' in line:
            rec = json.loads(line)
            out.setdefault(rec["step"], []).append(rec["loss"])
    return out


def test_cli_trains_experts_under_torchrun_and_resumes_on_one_process(tmp_path):
    """``torchrun --standalone`` starts two CPU ranks of the CLI under
    ``--rules tp_sp --mesh data=1,fsdp=1,seq=1,model=1,expert=2`` with a
    checkpoint at step 2; one process with no group then resumes that
    directory to step 4. Each logged loss equals one process's unbroken
    run on the same batches."""
    import subprocess
    import sys
    from pathlib import Path

    common = ["--device", "cpu", "--model", "llama-tiny-moe", "--rules", "tp_sp",
              "--batch-size", "2", "--seq-len", "16", "--log-every", "1", "--log-format",
              "json", "--warmup-steps", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    cli = ["-m", "oim_tpu_torch.cli.oim_trainer"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2"]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", *cli, *common, "--mesh", "data=1,fsdp=1,seq=1,model=1,expert=2", "--steps", "2",
         *ck], capture_output=True, text=True, timeout=180, env=env)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    one_axes = ["--mesh", "data=1,fsdp=1,seq=1,model=1,expert=1"]
    resumed = subprocess.run([sys.executable, *cli, *common, *one_axes, "--steps", "4", *ck],
                             capture_output=True, text=True, timeout=180, env=env)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    unbroken = subprocess.run([sys.executable, *cli, *common, *one_axes, "--steps", "4"],
                              capture_output=True, text=True, timeout=180, env=env)
    assert unbroken.returncode == 0, unbroken.stderr[-3000:]
    first = _steps_logged(ranks.stderr + ranks.stdout)
    after = _steps_logged(resumed.stderr)
    want = _steps_logged(unbroken.stderr)
    assert sorted(first) == [1, 2] and sorted(after) == [3, 4] and sorted(want) == [1, 2, 3, 4]
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [2, 4]
    for step, losses in {**first, **after}.items():
        np.testing.assert_allclose(losses, want[step] * len(losses), atol=LOSS_TOL)
