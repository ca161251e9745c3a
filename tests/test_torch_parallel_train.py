"""The port's meshed Trainer held against the JAX Trainer on the same axes,
on the CPU: llama-tiny, f32, 3 steps from the same initial params (they
cross as numpy, ``llama.from_numpy``) on the same global batches.

The port runs as gloo ranks (``tests/torch_parallel_worker.py``: one job
of 2 ranks and one of 4, started together, every scenario in each); JAX
runs its Trainer on the fake CPU devices of tests/conftest.py meanwhile.
Scenarios: ``dp`` over data=2; ``fsdp`` over data=2,fsdp=2; ``tp_sp`` over
seq=2 with each of ring, zigzag and Ulysses attention, and over
fsdp=2,seq=2 (zigzag); and three with an uneven ``ignore_index`` mask (one
over data=2, one with 2 accumulation microbatches, one over fsdp=2,seq=2),
where a mean of the ranks' own means would be wrong. Tensor parallelism
(tp_sp with model > 1): model=2; model=4, where llama-tiny's 2 KV heads
do not split over 4 ranks and wk/wv are gathered; fsdp=2,model=2;
seq=2,model=2 with zigzag and with Ulysses; Ulysses over seq=2,model=2
with 2/1 heads, where a rank's one query head does not split over seq
and the heads are gathered over model around the call; and the uneven
mask at model=2, whose -1 inputs embed the last vocabulary row, held by
the last model rank.

Tolerances (f32): per-step loss 1e-4 absolute (tests/test_torch_train.py's:
the frameworks sum in different orders and Adam's normalized update
carries last-bit differences into the next step), grad_norm 1e-4
relative, the gathered final params and eval loss 2e-4. Replicas of a
leaf (ranks that hold the same piece) must be equal to the bit after
every step.
"""

import jax
import numpy as np
import pytest

from oim_tpu.models import llama as jllama
from oim_tpu.train import trainer as jtrainer
from tests.torch_parallel_worker import Job, unflatten

STEPS = 3
JOB_TIMEOUT = 300.0
COMMON = dict(model="llama-tiny", lr=1e-2, warmup_steps=2, total_steps=10, log_every=1,
              seed=3)
SEQ2 = [("data", 1), ("fsdp", 1), ("seq", 2), ("model", 1)]
FSDP_SEQ = [("data", 1), ("fsdp", 2), ("seq", 2), ("model", 1)]
MODEL2 = [("data", 1), ("fsdp", 1), ("seq", 1), ("model", 2)]
SEQ_MODEL = [("data", 1), ("fsdp", 1), ("seq", 2), ("model", 2)]
# llama-tiny's shapes with 2 query heads of 32 and 1 KV head.
WIDE_HEADS = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 32}
# name -> (world, rules, axes, extra config, uneven ignore_index mask)
SCENARIOS = {
    "dp": (2, "dp", [("data", 2)], dict(batch_size=4, seq_len=16), False),
    "fsdp": (4, "fsdp", [("data", 2), ("fsdp", 2)], dict(batch_size=4, seq_len=16), False),
    "tp_sp_ring": (2, "tp_sp", SEQ2, dict(batch_size=2, seq_len=16, seq_parallel="ring"),
                   False),
    "tp_sp_zigzag": (2, "tp_sp", SEQ2, dict(batch_size=2, seq_len=16, seq_parallel="zigzag"),
                     False),
    "tp_sp_ulysses": (2, "tp_sp", SEQ2,
                      dict(batch_size=2, seq_len=16, seq_parallel="ulysses"), False),
    "tp_sp_fsdp_seq": (4, "tp_sp", FSDP_SEQ,
                       dict(batch_size=2, seq_len=16, seq_parallel="zigzag"), False),
    "uneven_dp": (2, "dp", [("data", 2)], dict(batch_size=4, seq_len=16), True),
    "uneven_dp_accum": (2, "dp", [("data", 2)], dict(batch_size=4, seq_len=16,
                                                     accum_steps=2), True),
    "uneven_fsdp_seq": (4, "tp_sp", FSDP_SEQ,
                        dict(batch_size=2, seq_len=16, seq_parallel="zigzag"), True),
    "tp_model2": (2, "tp_sp", MODEL2, dict(batch_size=2, seq_len=16), False),
    "tp_model4": (4, "tp_sp", [("data", 1), ("fsdp", 1), ("seq", 1), ("model", 4)],
                  dict(batch_size=2, seq_len=16), False),
    "tp_fsdp_model": (4, "tp_sp", [("data", 1), ("fsdp", 2), ("seq", 1), ("model", 2)],
                      dict(batch_size=4, seq_len=16), False),
    "tp_seq_zigzag": (4, "tp_sp", SEQ_MODEL,
                      dict(batch_size=2, seq_len=16, seq_parallel="zigzag"), False),
    "tp_seq_ulysses": (4, "tp_sp", SEQ_MODEL,
                       dict(batch_size=2, seq_len=16, seq_parallel="ulysses"), False),
    "tp_seq_ulysses_gathered": (4, "tp_sp", SEQ_MODEL,
                                dict(batch_size=2, seq_len=16, seq_parallel="ulysses",
                                     model_overrides=WIDE_HEADS), False),
    "uneven_tp": (2, "tp_sp", MODEL2, dict(batch_size=2, seq_len=16), True),
}


def _uneven_tokens(rng, vocab, steps, b, t):
    """Token batches with -1 (ignore_index) labels packed into the first
    half of the rows and, within a row, the early positions: every data,
    fsdp and seq shard keeps a different count. A -1 input token is
    embedded as the vocabulary's last row in both packages."""
    toks = rng.randint(0, vocab, (steps, b, t + 1)).astype(np.int32)
    for row in range(b // 2):
        cut = rng.randint(t // 2, t)
        drop = rng.rand(steps, cut) < 0.7
        toks[:, row, 1:cut + 1][drop] = -1
    return toks


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_run(name, init_params, tokens, eval_tokens):
    world, rules, axes, extra, _ = SCENARIOS[name]
    jcfg = jtrainer.TrainConfig(rules=rules, **COMMON, **extra)
    tr = jtrainer.Trainer(jcfg, axes=axes)
    tr.init_or_resume()
    for k, v in _flat(jax.tree.map(np.asarray, tr.state.params)).items():
        np.testing.assert_array_equal(v, init_params[k])
    data = (iter({"tokens": t} for t in tokens) if tokens is not None
            else jtrainer.synthetic_batches(jcfg))
    losses, norms = [], []
    for _ in range(STEPS):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
    final = _flat(jax.tree.map(np.asarray, tr.state.params))
    eval_loss = tr.evaluate(iter([{"tokens": eval_tokens}]), 1)
    return {"losses": losses, "norms": norms, "final": final, "eval": eval_loss}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    jcfg = jllama.tiny()
    # The JAX Trainer's own (jitted) init, which every scenario repeats.
    first = jtrainer.Trainer(jtrainer.TrainConfig(**COMMON), axes=[("data", 1)])
    first.init_or_resume()
    params = _flat(jax.tree.map(np.asarray, first.state.params))
    rng = np.random.RandomState(10)
    batches, evals = {}, {}
    for name, (_, _, _, extra, uneven) in SCENARIOS.items():
        b, t = extra["batch_size"], extra["seq_len"]
        batches[name] = _uneven_tokens(rng, jcfg.vocab, STEPS, b, t) if uneven else None
        evals[name] = (_uneven_tokens(rng, jcfg.vocab, 1, b, t)[0] if uneven
                       else rng.randint(0, jcfg.vocab, (b, t + 1)).astype(np.int32))
    jobs = {}
    for world in (2, 4):
        inputs = {f"params/{k}": v for k, v in params.items()}
        scenarios = []
        for name, (w, rules, axes, extra, _) in SCENARIOS.items():
            if w != world:
                continue
            if batches[name] is not None:
                inputs[f"{name}/tokens"] = batches[name]
            inputs[f"{name}/eval_tokens"] = evals[name]
            scenarios.append({"type": "train", "name": name, "axes": axes, "steps": STEPS,
                              "cfg": dict(rules=rules, **COMMON, **extra)})
        jobs[world] = Job(tmp, world, inputs, scenarios, JOB_TIMEOUT)
    want = {name: _jax_run(name, params, batches[name], evals[name]) for name in SCENARIOS}
    got = {world: job.results() for world, job in jobs.items()}
    return params, batches, got, want


def _ranks(got, name):
    return got[SCENARIOS[name][0]]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_losses_and_grad_norms_match_jax_trainer(runs, name):
    _, _, got, want = runs
    for r in _ranks(got, name):  # every rank reports the global values
        losses = [float(r[f"{name}/loss{i}"]) for i in range(STEPS)]
        norms = [float(r[f"{name}/grad_norm{i}"]) for i in range(STEPS)]
        np.testing.assert_allclose(losses, want[name]["losses"], atol=1e-4)
        np.testing.assert_allclose(norms, want[name]["norms"], rtol=1e-4)
    assert all(np.isfinite(want[name]["losses"]))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_final_params_and_eval_loss_match_jax_trainer(runs, name):
    _, _, got, want = runs
    for r in _ranks(got, name):
        for leaf, w in want[name]["final"].items():
            np.testing.assert_allclose(r[f"{name}/final/{leaf}"], w, atol=2e-4, err_msg=leaf)
        np.testing.assert_allclose(float(r[f"{name}/eval_loss"]), want[name]["eval"],
                                   atol=2e-4)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_stay_equal_across_ranks_after_every_step(runs, name):
    """Ranks holding the same piece of a leaf hold the same bits; under
    fsdp each rank holds half of every weight sharded on its embed dim."""
    params, _, got, _ = runs
    ranks = _ranks(got, name)
    for step in range(STEPS):
        for leaf in params:
            by_piece: dict = {}
            for r in ranks:
                by_piece.setdefault(tuple(r[f"{name}/piece/{leaf}"]), []).append(
                    r[f"{name}/shard{step}/{leaf}"])
            for pieces in by_piece.values():
                for other in pieces[1:]:
                    np.testing.assert_array_equal(other, pieces[0],
                                                  err_msg=f"{leaf} step {step + 1}")
    world, rules, axes, _, _ = SCENARIOS[name]
    fsdp, model = dict(axes).get("fsdp", 1), dict(axes).get("model", 1)
    norms = sum(params[leaf].size for leaf in params if "norm" in leaf)
    total = sum(v.size for v in params.values())
    for r in ranks:
        held = sum(r[f"{name}/shard0/{leaf}"].size for leaf in params)
        if rules in ("fsdp", "tp_sp"):
            # every leaf but the norms splits over fsdp and, under tp_sp,
            # over model (heads, kv heads, mlp or vocab)
            split = fsdp * (model if rules == "tp_sp" else 1)
            assert held == (total - norms) // split + norms
        else:
            assert held == total


def test_uneven_mask_needs_the_global_mean(runs):
    """The first step's loss is the mean over every kept label of the
    global batch. The mean of each data rank's own mean differs from it
    by far more than the tolerance when ranks keep different counts."""
    params, batches, got, want = runs
    tokens = batches["uneven_dp"][0]
    jp = jax.tree.map(np.asarray, unflatten(params))
    cfg = jllama.tiny()
    own = [float(jllama.loss_fn(jp, tokens[rows], cfg)) for rows in (slice(0, 2), slice(2, 4))]
    kept = [(tokens[rows, 1:] != -1).sum() for rows in (slice(0, 2), slice(2, 4))]
    assert kept[0] < kept[1]
    first = want["uneven_dp"]["losses"][0]
    assert abs(np.mean(own) - first) > 10 * 1e-4
    np.testing.assert_allclose(np.dot(own, kept) / sum(kept), first, atol=1e-5)
    for r in _ranks(got, "uneven_dp"):
        np.testing.assert_allclose(float(r["uneven_dp/loss0"]), first, atol=1e-4)


# ---------------------------------------------------- CLI and refusals ----


def test_cli_mesh_flags_match_jax_cli(monkeypatch):
    from oim_tpu.cli import oim_trainer as jcli
    from oim_tpu_torch.cli import oim_trainer as tcli

    argv = ["--rules", "tp_sp", "--seq-parallel", "zigzag", "--mesh", "data=1,seq=2",
            "--steps", "3"]
    seen = {}

    class Catch:
        def __init__(self, cfg, **kw):
            seen["cfg"], seen["axes"] = cfg, kw.get("axes")

        def run(self, **kw):
            return 0.0

    monkeypatch.setattr(jcli, "Trainer", Catch)
    jcli.main(argv + ["--log-level", "error"])
    args = tcli.parse_args(argv)
    got = tcli.config_from_args(args)
    assert (got.rules, got.seq_parallel) == (seen["cfg"].rules, seen["cfg"].seq_parallel)
    assert tcli.parse_mesh(args.mesh) == seen["axes"] == [("data", 1), ("seq", 2)]
    defaults = tcli.parse_args([])
    assert (defaults.rules, defaults.seq_parallel, defaults.mesh) == ("dp", "ring", "")
    for bad in ("data", "data=x"):
        with pytest.raises(SystemExit) as jerr:
            jcli.parse_mesh(bad)
        with pytest.raises(SystemExit) as terr:
            tcli.parse_mesh(bad)
        assert str(terr.value) == str(jerr.value)


def test_unported_mesh_options_refuse_naming_their_slice():
    from oim_tpu_torch.parallel.mesh import Mesh
    from oim_tpu_torch.train import trainer as ttrainer

    two = Mesh([("data", 2)], [0, 1], "cpu")  # shape only: no process group
    cfg = ttrainer.TrainConfig

    # Pipe is ported: the rules pass without a mesh, and a pipe axis splits
    # nothing under the other rules.
    cfg(rules="pipe").check_supported(None)
    # Tensor parallelism is ported, a model axis that splits a query head
    # too; one that does not divide the columns is refused, as JAX's
    # device_put refuses it.
    model2 = Mesh([("data", 1), ("model", 2)], [0, 1], "cpu")
    cfg(rules="tp_sp").check_supported(model2)
    cfg(rules="tp_sp", model_overrides={"n_heads": 3, "head_dim": 16}).check_supported(model2)
    with pytest.raises(ValueError, match=r"does not divide n_heads x head_dim \(45\)"):
        cfg(rules="tp_sp", model_overrides={"n_heads": 3, "head_dim": 15}).check_supported(
            model2)
    # Ulysses beside a model axis that splits a query head runs on the
    # whole heads (tests/test_torch_tp_headsplit.py holds it against JAX).
    cfg(rules="tp_sp", seq_parallel="ulysses",
        model_overrides={"n_heads": 6, "n_kv_heads": 2, "head_dim": 16}).check_supported(
        Mesh([("data", 1), ("seq", 2), ("model", 4)], list(range(8)), "cpu"))
    # A pipe axis under rules other than "pipe" splits nothing: replicated.
    cfg().check_supported(Mesh([("data", 1), ("pipe", 2)], [0, 1], "cpu"))
    # Ported since: the expert axis, MoE and ResNet across ranks, and
    # checkpoints under a mesh.
    expert2 = Mesh([("data", 1), ("expert", 2)], [0, 1], "cpu")
    cfg().check_supported(expert2)
    cfg(model="llama-tiny-moe", rules="tp_sp").check_supported(expert2)
    cfg(model="resnet50").check_supported(two)
    cfg(model="llama-tiny-moe").check_supported(two)
    cfg(model="llama-tiny-moe", rules="tp_sp").check_supported(model2)
    cfg(checkpoint_dir="ck").check_supported(two)
    cfg().check_supported(two)
    cfg(model="resnet50").check_supported(Mesh([("data", 1)], [0], "cpu"))
    # The JAX trainer's mesh errors: an axis the rules name must exist.
    with pytest.raises(ValueError, match="Resource axis: data"):
        ttrainer.Trainer(cfg(rules="fsdp"), device="cpu", axes=[("fsdp", 1)])
    with pytest.raises(ValueError, match="require 2 devices, have 1"):
        ttrainer.Trainer(cfg(), device="cpu", axes=[("data", 2)])


def _steps_logged(text: str) -> list[float]:
    import json

    out = []
    for line in text.splitlines():
        if line.startswith("{") and '"msg": "step"' in line:
            out.append(json.loads(line)["loss"])
    return out


def test_cli_under_torchrun_trains_on_two_ranks():
    """``torchrun --standalone`` (a free localhost port) starts two CPU
    ranks of the CLI under fsdp; each logs the global loss, equal to one
    process's dp run on the same global batches."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    common = ["--device", "cpu", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
              "--log-every", "1", "--log-format", "json", "--warmup-steps", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "oim_tpu_torch.cli.oim_trainer", "--rules", "fsdp", "--mesh",
         "data=1,fsdp=2", *common], capture_output=True, text=True, timeout=180, env=env)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "oim_tpu_torch.cli.oim_trainer", *common],
                         capture_output=True, text=True, timeout=180, env=env)
    assert one.returncode == 0, one.stderr[-3000:]
    both, single = _steps_logged(ranks.stderr + ranks.stdout), _steps_logged(one.stderr)
    assert len(single) == 2 and len(both) == 4
    np.testing.assert_allclose(sorted(both), sorted(single * 2), atol=1e-5)


def test_cli_under_torchrun_tensor_parallel_on_two_ranks():
    """The CLI's ``--rules tp_sp --mesh data=1,fsdp=1,seq=1,model=2`` under
    ``torchrun`` on two CPU ranks: each logs the global loss, equal to one
    process's run on the same batches."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    common = ["--device", "cpu", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
              "--log-every", "1", "--log-format", "json", "--warmup-steps", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "oim_tpu_torch.cli.oim_trainer", "--rules", "tp_sp", "--mesh",
         "data=1,fsdp=1,seq=1,model=2", *common], capture_output=True, text=True,
        timeout=180, env=env)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "oim_tpu_torch.cli.oim_trainer", *common],
                         capture_output=True, text=True, timeout=180, env=env)
    assert one.returncode == 0, one.stderr[-3000:]
    both, single = _steps_logged(ranks.stderr + ranks.stdout), _steps_logged(one.stderr)
    assert len(single) == 2 and len(both) == 4
    np.testing.assert_allclose(sorted(both), sorted(single * 2), atol=1e-5)
