"""MoE across ranks: the port's meshed Trainer on llama-tiny-moe held
against the JAX Trainer on the same axes, on the CPU, f32, 3 steps from
the same initial params on the same global batches.

``moe_capacity_factor`` is 0.5, so that tokens are dropped at a random
init: a slot is then decided by the global order of the tokens routed to
an expert, and per-rank routing would drop others. Scenarios: ``dp``
data=2 (and with 2 accumulation microbatches), ``fsdp`` fsdp=2, and under
``tp_sp`` expert=2 (expert parallelism), data=2,expert=2 (the JAX
package's own expert-parallel test mesh, on 4 ranks), model=2 (each
expert's MLP split Megatron's way) and seq=2 with ring and with zigzag
attention (a zigzag rank holds two chunks of each row). The port runs as
gloo ranks (``tests/torch_parallel_worker.py``), JAX on the fake CPU
devices of tests/conftest.py meanwhile.

Tolerances (tests/test_torch_parallel_train.py's): per-step loss 1e-4
absolute, grad_norm 1e-4 relative, the gathered final params and eval
loss 2e-4, ``moe_drop_frac`` 1e-6 at every step, replicas equal to the
bit. Three faults planted in the worker must each break one of them:
per-rank routing (local capacity and slots), the plain all_gather of the
router's columns (whose reduce-scatter backward doubles the router's
gradient over expert=2), and the load-balance loss counted in full on
every data rank.
"""

import jax
import numpy as np
import pytest

from oim_tpu.models import llama as jllama
from oim_tpu.models import moe as jmoe
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.models import moe as tmoe
from oim_tpu_torch.train import trainer as ttrainer
from tests.torch_parallel_worker import Job

STEPS = 3
JOB_TIMEOUT = 300.0
LOSS_TOL, NORM_TOL, PARAM_TOL, DROP_TOL = 1e-4, 1e-4, 2e-4, 1e-6
COMMON = dict(model="llama-tiny-moe", lr=1e-2, warmup_steps=2, total_steps=10, log_every=1,
              seed=3, model_overrides={"moe_capacity_factor": 0.5})


def tp(data=1, fsdp=1, seq=1, model=1, expert=1):
    return [("data", data), ("fsdp", fsdp), ("seq", seq), ("model", model),
            ("expert", expert)]


# name -> (world, rules, axes, extra config)
SCENARIOS = {
    "dp": (2, "dp", [("data", 2)], dict(batch_size=4, seq_len=16)),
    "fsdp": (2, "fsdp", [("data", 1), ("fsdp", 2)], dict(batch_size=4, seq_len=16)),
    "ep": (2, "tp_sp", tp(expert=2), dict(batch_size=2, seq_len=16)),
    "data_ep": (4, "tp_sp", tp(data=2, expert=2), dict(batch_size=4, seq_len=16)),
    "model": (2, "tp_sp", tp(model=2), dict(batch_size=2, seq_len=16)),
    "seq_ring": (2, "tp_sp", tp(seq=2), dict(batch_size=2, seq_len=16, seq_parallel="ring")),
    "seq_zigzag": (2, "tp_sp", tp(seq=2),
                   dict(batch_size=2, seq_len=16, seq_parallel="zigzag")),
    "dp_accum": (2, "dp", [("data", 2)], dict(batch_size=4, seq_len=16, accum_steps=2)),
}
# fault -> the scenario it is planted in
FAULTS = {"local_routing": "dp", "rs_backward": "ep", "aux_everywhere": "dp"}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_run(name, init_params, eval_tokens):
    world, rules, axes, extra = SCENARIOS[name]
    jcfg = jtrainer.TrainConfig(rules=rules, **COMMON, **extra)
    tr = jtrainer.Trainer(jcfg, axes=axes)
    tr.init_or_resume()
    for k, v in _flat(jax.tree.map(np.asarray, tr.state.params)).items():
        np.testing.assert_array_equal(v, init_params[k])
    data = jtrainer.synthetic_batches(jcfg)
    losses, norms, drops = [], [], []
    for _ in range(STEPS):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
        drops.append(float(stats["moe_drop_frac"]))
    final = _flat(jax.tree.map(np.asarray, tr.state.params))
    eval_loss = tr.evaluate(iter([{"tokens": eval_tokens}]), 1)
    return {"losses": losses, "norms": norms, "drops": drops, "final": final,
            "eval": eval_loss}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    first = jtrainer.Trainer(jtrainer.TrainConfig(**COMMON), axes=[("data", 1)])
    first.init_or_resume()
    params = _flat(jax.tree.map(np.asarray, first.state.params))
    rng = np.random.RandomState(12)
    vocab = jllama.tiny(n_experts=4).vocab
    evals = {name: rng.randint(0, vocab, (extra["batch_size"], extra["seq_len"] + 1)
                               ).astype(np.int32)
             for name, (_, _, _, extra) in SCENARIOS.items()}
    # gather_from against all_gather: the same cotangent on both ranks.
    x = rng.randn(4, 6).astype(np.float32)
    cot = rng.randn(2, 12).astype(np.float32)
    gather = {"gather/x": x, **{f"gather/c_{op}": np.concatenate([cot, cot])
                                for op in ("gather_from", "all_gather")}}
    jobs = {}
    for world in (2, 4):
        inputs = {f"params/{k}": v for k, v in params.items()}
        scenarios = []
        if world == 2:
            inputs.update(gather)
            scenarios.append({"type": "collectives", "name": "gather", "axes": [("x", 2)],
                              "ops": ["gather_from", "all_gather"]})
        for name, (w, rules, axes, extra) in SCENARIOS.items():
            if w != world:
                continue
            inputs[f"{name}/eval_tokens"] = evals[name]
            cfg = dict(rules=rules, **COMMON, **extra)
            scenarios.append({"type": "train", "name": name, "axes": axes, "steps": STEPS,
                              "cfg": cfg})
            for fault in (f for f, on in FAULTS.items() if on == name):
                inputs[f"{fault}/eval_tokens"] = evals[name]
                scenarios.append({"type": "train", "name": fault, "axes": axes,
                                  "steps": STEPS, "cfg": cfg, "fault": fault})
        jobs[world] = Job(tmp, world, inputs, scenarios, JOB_TIMEOUT)
    want = {name: _jax_run(name, params, evals[name]) for name in SCENARIOS}
    got = {world: job.results() for world, job in jobs.items()}
    return params, got, want, (x, cot)


def _ranks(got, name):
    return got[SCENARIOS[FAULTS.get(name, name)][0]]


def _deviation(r, name, want) -> dict:
    """How far one rank's run is from JAX's, by each measure."""
    losses = [float(r[f"{name}/loss{i}"]) for i in range(STEPS)]
    norms = [float(r[f"{name}/grad_norm{i}"]) for i in range(STEPS)]
    drops = [float(r[f"{name}/drop{i}"]) for i in range(STEPS)]
    return {
        "loss": max(abs(a - b) for a, b in zip(losses, want["losses"])),
        "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(norms, want["norms"])),
        "drop": max(abs(a - b) for a, b in zip(drops, want["drops"])),
        "params": max(float(np.abs(r[f"{name}/final/{leaf}"] - w).max())
                      for leaf, w in want["final"].items()),
    }


LIMITS = {"loss": LOSS_TOL, "grad_norm": NORM_TOL, "drop": DROP_TOL, "params": PARAM_TOL}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_losses_grad_norms_and_drops_match_jax_trainer(runs, name):
    _, got, want, _ = runs
    assert max(want[name]["drops"]) > 0.05  # capacity 0.5 drops tokens
    for r in _ranks(got, name):  # every rank reports the global values
        losses = [float(r[f"{name}/loss{i}"]) for i in range(STEPS)]
        norms = [float(r[f"{name}/grad_norm{i}"]) for i in range(STEPS)]
        drops = [float(r[f"{name}/drop{i}"]) for i in range(STEPS)]
        np.testing.assert_allclose(losses, want[name]["losses"], atol=LOSS_TOL)
        np.testing.assert_allclose(norms, want[name]["norms"], rtol=NORM_TOL)
        np.testing.assert_allclose(drops, want[name]["drops"], atol=DROP_TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_final_params_and_eval_loss_match_jax_trainer(runs, name):
    _, got, want, _ = runs
    for r in _ranks(got, name):
        for leaf, w in want[name]["final"].items():
            np.testing.assert_allclose(r[f"{name}/final/{leaf}"], w, atol=PARAM_TOL,
                                       err_msg=leaf)
        np.testing.assert_allclose(float(r[f"{name}/eval_loss"]), want[name]["eval"],
                                   atol=PARAM_TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_stay_equal_and_experts_split(runs, name):
    """Ranks holding the same piece of a leaf hold the same bits after
    every step; over ``expert`` each rank holds its share of the experts
    (and of the router's columns), over ``model`` its share of each
    expert's MLP."""
    params, got, _, _ = runs
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
    axes = dict(SCENARIOS[name][2])
    moe_leaves = [leaf for leaf in params if ".moe." in leaf]
    for r in ranks:
        for leaf in moe_leaves:
            held, full = r[f"{name}/shard0/{leaf}"].size, params[leaf].size
            split = axes.get("expert", 1) * (axes.get("fsdp", 1))
            if not leaf.endswith("router"):
                split *= axes.get("model", 1)
            assert held * split == full, leaf


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_break_the_limits(runs, fault):
    _, got, want, _ = runs
    ref = want[FAULTS[fault]]
    worst = {k: max(_deviation(r, fault, ref)[k] for r in _ranks(got, fault)) for k in LIMITS}
    sound = {k: max(_deviation(r, FAULTS[fault], ref)[k] for r in _ranks(got, fault))
             for k in LIMITS}
    assert all(sound[k] <= LIMITS[k] for k in LIMITS), sound
    assert any(worst[k] > LIMITS[k] for k in LIMITS), (fault, worst)


def test_moe_logical_axes_match_jax():
    for stacked in (False, True):
        assert tmoe.param_logical_axes(stacked) == jmoe.param_logical_axes(stacked)
    assert (tllama.param_logical_axes(tllama.tiny(n_experts=4))
            == jllama.param_logical_axes(jllama.tiny(n_experts=4)))


def test_moe_under_tp_sp_without_an_expert_axis_fails_as_jax():
    axes = [("data", 1), ("fsdp", 1), ("seq", 1), ("model", 1)]
    kw = dict(model="llama-tiny-moe", rules="tp_sp", batch_size=2, seq_len=16)
    with pytest.raises(ValueError) as jerr:
        jtrainer.Trainer(jtrainer.TrainConfig(**kw), axes=axes)
    with pytest.raises(ValueError) as terr:
        ttrainer.Trainer(ttrainer.TrainConfig(**kw), device="cpu", axes=axes)
    assert str(terr.value) == str(jerr.value)
    assert "Resource axis: expert" in str(terr.value)


def test_gather_from_keeps_the_slice_all_gather_sums(runs):
    """gather_from concatenates the ranks' blocks as all_gather does; fed
    the same (whole) cotangent on both ranks, its backward is this rank's
    slice of it, where all_gather's reduce-scatter returns twice that."""
    _, got, _, (x, cot) = runs
    full = np.concatenate([x[:2], x[2:]], axis=1)
    for rank, r in enumerate(got[2]):
        mine = cot[:, rank * 6:(rank + 1) * 6]
        for op in ("gather_from", "all_gather"):
            np.testing.assert_array_equal(r[f"gather/{op}/y"], full)
        np.testing.assert_array_equal(r["gather/gather_from/dx"], mine)
        np.testing.assert_allclose(r["gather/all_gather/dx"], 2 * mine, rtol=1e-6)


def test_cli_dtype_override_names_a_torch_dtype():
    """``--override dtype=float32`` (how chip_smoke runs a model in f32
    through the CLI) gives the model config a torch dtype; a name that is
    not one exits."""
    import torch

    from oim_tpu_torch.cli import oim_trainer as tcli

    args = tcli.parse_args(["--model", "llama-tiny-moe", "--override", "dtype=bfloat16",
                            "--override", "n_layers=3"])
    mcfg = tcli.config_from_args(args).model_config()
    assert mcfg.dtype is torch.bfloat16 and mcfg.n_layers == 3
    with pytest.raises(SystemExit, match="not a torch dtype"):
        tcli.config_from_args(tcli.parse_args(["--override", "dtype=float99"]))
