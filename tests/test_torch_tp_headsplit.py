"""The port's Trainer on the last meshes it used to refuse, held against
the JAX Trainer on the same axes, on the CPU: llama-tiny (and
llama-tiny-moe), f32, 3 steps from the same initial params on the same
synthetic global batches.

* A ``model`` axis that splits a query head (tp_sp): 6 heads of 16 (2 KV
  heads) over model=4; 3 heads (1 KV head) over model=2, over
  fsdp=2,model=2 and over seq=2,model=2 with zigzag attention;
  llama-tiny's 4 heads over model=8; and 6 heads over seq=2,model=4 with
  Ulysses attention, which runs on the whole heads gathered over model.
  JAX cuts wq/wk/wv by columns and wo
  by rows evenly over the axis, so a head straddles two ranks; the port
  cuts the same bytes, gathers q over the axis, attends on the whole
  heads each rank's columns touch and keeps its own columns.
* Axes the rules do not split over, which the JAX Trainer replicates
  over: model=2 beside pipe=2 (GPipe and 1F1B), expert=2 beside pipe=2
  with llama-tiny-moe, and pipe=2 under dp.
* The planted fault: ``gather_from`` in place of q's ``all_gather``
  (its backward keeps this rank's share of a straddling head's cotangent
  and drops the other rank's) must break the comparison.

The port runs as gloo ranks (``tests/torch_parallel_worker.py``: one job
of 2 ranks and one of 4, while JAX runs its Trainer on the fake CPU
devices of tests/conftest.py, then one of 8). Tolerances are
tests/test_torch_parallel_train.py's (f32): per-step loss 1e-4 absolute,
grad_norm 1e-4 relative, the gathered final params and the eval loss
2e-4. Replicas of a leaf must be equal to the bit after every step.
"""

import jax
import numpy as np
import pytest

from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.parallel.mesh import Mesh
from oim_tpu_torch.train import trainer as ttrainer
from tests.torch_parallel_worker import Job

STEPS = 3
JOB_TIMEOUT = 300.0
COMMON = dict(lr=1e-2, warmup_steps=2, total_steps=10, log_every=1, seed=3, seq_len=16)
THREE = {"n_heads": 3, "n_kv_heads": 1, "head_dim": 16}
SIX = {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16}


def _tp(**axes):
    return [("data", axes.get("data", 1)), ("fsdp", axes.get("fsdp", 1)),
            ("seq", axes.get("seq", 1)), ("model", axes.get("model", 1))]


# name -> (world, model, rules, axes, extra config, planted fault)
SCENARIOS = {
    "heads3_model2": (2, "llama-tiny", "tp_sp", _tp(model=2),
                      dict(batch_size=2, model_overrides=THREE), None),
    "heads3_model2_gather_from": (2, "llama-tiny", "tp_sp", _tp(model=2),
                                  dict(batch_size=2, model_overrides=THREE), "gather_from"),
    "heads6_model4": (4, "llama-tiny", "tp_sp", _tp(model=4),
                      dict(batch_size=2, model_overrides=SIX), None),
    "heads3_fsdp2_model2": (4, "llama-tiny", "tp_sp", _tp(fsdp=2, model=2),
                            dict(batch_size=4, model_overrides=THREE), None),
    "heads3_seq2_model2_zigzag": (4, "llama-tiny", "tp_sp", _tp(seq=2, model=2),
                                  dict(batch_size=2, seq_parallel="zigzag",
                                       model_overrides=THREE), None),
    "heads4_model8": (8, "llama-tiny", "tp_sp", _tp(model=8), dict(batch_size=2), None),
    "heads6_seq2_model4_ulysses": (8, "llama-tiny", "tp_sp", _tp(seq=2, model=4),
                                   dict(batch_size=2, seq_parallel="ulysses",
                                        model_overrides=SIX), None),
    "pipe2_model2": (4, "llama-tiny", "pipe", [("data", 1), ("pipe", 2), ("model", 2)],
                     dict(batch_size=4, microbatches=2), None),
    "pipe2_model2_1f1b": (4, "llama-tiny", "pipe", [("data", 1), ("pipe", 2), ("model", 2)],
                          dict(batch_size=4, microbatches=2, pipeline_schedule="1f1b"), None),
    "pipe2_expert2_moe": (4, "llama-tiny-moe", "pipe",
                          [("data", 1), ("pipe", 2), ("expert", 2)],
                          dict(batch_size=4, microbatches=2), None),
    "dp_data2_pipe2": (4, "llama-tiny", "dp", [("data", 2), ("pipe", 2)],
                       dict(batch_size=4), None),
}
SOUND = [n for n, sc in SCENARIOS.items() if sc[5] is None]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _cfg(name: str) -> dict:
    _, model, rules, _, extra, _ = SCENARIOS[name]
    return dict(model=model, rules=rules, **COMMON, **extra)


def _params_key(name: str) -> str:
    _, model, _, _, extra, _ = SCENARIOS[name]
    return f"{model}-{sorted(extra.get('model_overrides', {}).items())}"


def _jax_run(name, eval_tokens):
    _, _, _, axes, _, _ = SCENARIOS[name]
    jcfg = jtrainer.TrainConfig(**_cfg(name))
    tr = jtrainer.Trainer(jcfg, axes=axes)
    tr.init_or_resume()
    data = jtrainer.synthetic_batches(jcfg)
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
    tmp = tmp_path_factory.mktemp("tp_headsplit")
    # Each model shape's initial params: the JAX Trainer's own (jitted) init
    # on one device, which every meshed JAX run repeats.
    params = {}
    for name in SCENARIOS:
        key = _params_key(name)
        if key not in params:
            cfg = {k: v for k, v in _cfg(name).items() if k not in ("rules", "microbatches",
                                                                   "pipeline_schedule")}
            first = jtrainer.Trainer(jtrainer.TrainConfig(**cfg), axes=[("data", 1)])
            first.init_or_resume()
            params[key] = _flat(jax.tree.map(np.asarray, first.state.params))
    keys = sorted(params)
    rng = np.random.RandomState(14)
    evals = {name: rng.randint(0, 256, (_cfg(name)["batch_size"], COMMON["seq_len"] + 1))
             .astype(np.int32) for name in SCENARIOS}

    def job(world):
        inputs, scenarios = {}, []
        for name, (w, _, _, axes, _, fault) in SCENARIOS.items():
            if w != world:
                continue
            prefix = f"params{keys.index(_params_key(name))}/"
            inputs.update({f"{prefix}{k}": v for k, v in params[_params_key(name)].items()})
            inputs[f"{name}/eval_tokens"] = evals[name]
            scenarios.append({"type": "train", "name": name, "axes": axes, "steps": STEPS,
                              "cfg": _cfg(name), "params": prefix, "fault": fault})
        return Job(tmp, world, inputs, scenarios, JOB_TIMEOUT)

    # The worlds of 2 and 4 ranks run beside the JAX runs, the world of 8
    # after them: at most 8 rank processes at a time.
    jobs = {world: job(world) for world in (2, 4)}
    want = {name: _jax_run(name, evals[name]) for name in SOUND}
    got = {world: j.results() for world, j in jobs.items()}
    got[8] = job(8).results()
    return params, got, want


def _ranks(got, name):
    return got[SCENARIOS[name][0]]


def _within(r, name, want) -> bool:
    """Whether one rank's run matches the JAX Trainer's within the
    tolerances; raises with the first miss."""
    losses = [float(r[f"{name}/loss{i}"]) for i in range(STEPS)]
    norms = [float(r[f"{name}/grad_norm{i}"]) for i in range(STEPS)]
    np.testing.assert_allclose(losses, want["losses"], atol=1e-4)
    np.testing.assert_allclose(norms, want["norms"], rtol=1e-4)
    for leaf, w in want["final"].items():
        np.testing.assert_allclose(r[f"{name}/final/{leaf}"], w, atol=2e-4, err_msg=leaf)
    np.testing.assert_allclose(float(r[f"{name}/eval_loss"]), want["eval"], atol=2e-4)
    return True


@pytest.mark.parametrize("name", SOUND)
def test_losses_grad_norms_and_final_params_match_jax_trainer(runs, name):
    _, got, want = runs
    assert all(np.isfinite(want[name]["losses"]))
    for r in _ranks(got, name):
        assert _within(r, name, want[name])


@pytest.mark.parametrize("name", SOUND)
def test_replicas_stay_equal_across_ranks_after_every_step(runs, name):
    """Ranks holding the same piece of a leaf hold the same bits: the
    ranks of a replicated axis (model or expert beside pipe, pipe under
    dp) hold every piece twice."""
    params, got, _ = runs
    ranks = _ranks(got, name)
    leaves = params[_params_key(name)]
    replicated = 0
    for step in range(STEPS):
        for leaf in leaves:
            by_piece: dict = {}
            for r in ranks:
                by_piece.setdefault(tuple(r[f"{name}/piece/{leaf}"]), []).append(
                    r[f"{name}/shard{step}/{leaf}"])
            for pieces in by_piece.values():
                replicated += len(pieces) > 1
                for other in pieces[1:]:
                    np.testing.assert_array_equal(other, pieces[0],
                                                  err_msg=f"{leaf} step {step + 1}")
    assert replicated


def test_head_split_cuts_the_bytes_jax_puts_on_each_device(runs):
    """At model=2 with 3 heads of 16, each rank holds 24 of wq's 48
    columns (a head and a half) and the matching 24 rows of wo, as the
    JAX Trainer's device_put of TP_SP_RULES lays them out."""
    params, got, _ = runs
    name = "heads3_model2"
    full = params[_params_key(name)]
    for rank, r in enumerate(_ranks(got, name)):
        assert r[f"{name}/shard0/layers.wq"].shape == (2, 64, 24)
        assert r[f"{name}/shard0/layers.wo"].shape == (2, 24, 64)
        assert tuple(r[f"{name}/piece/layers.wq"]) == (0, 0, rank)
        assert full["layers.wq"].shape == (2, 64, 48)


def test_gather_from_in_place_of_the_q_gather_breaks_the_comparison(runs):
    """The trap of a head split: ``gather_from``'s backward keeps this
    rank's share of the straddling head's cotangent, so the gradient of
    wq's columns in that head lacks the other rank's share. The sound run
    of the same mesh matches JAX (above); the planted one must not."""
    _, got, want = runs
    name, ref = "heads3_model2_gather_from", want["heads3_model2"]
    for r in _ranks(got, name):
        with pytest.raises(AssertionError):
            _within(r, name, ref)
        assert float(r[f"{name}/loss0"]) == pytest.approx(ref["losses"][0], abs=1e-4)
        assert abs(float(r[f"{name}/grad_norm0"]) - ref["norms"][0]) > 1e-4 * ref["norms"][0]


def _jax_error(cfg: dict, axes) -> str:
    tr = jtrainer.Trainer(jtrainer.TrainConfig(**cfg), axes=axes)
    with pytest.raises(ValueError) as err:
        tr.init_or_resume()
    return str(err.value)


def test_pipe_meshes_accept_replicated_axes():
    """model and expert beside pipe, and pipe under dp: axes the rules do
    not split over, replicated as in the JAX trainer (the runs above hold
    them against it), so nothing refuses them."""
    cfg = ttrainer.TrainConfig
    cfg(rules="pipe").check_supported(Mesh([("data", 1), ("pipe", 2), ("model", 2)],
                                           [0, 1, 2, 3], "cpu"))
    cfg(model="llama-tiny-moe", rules="pipe").check_supported(
        Mesh([("data", 1), ("pipe", 2), ("expert", 2)], [0, 1, 2, 3], "cpu"))
    cfg(rules="dp").check_supported(Mesh([("data", 2), ("pipe", 2)], [0, 1, 2, 3], "cpu"))


def test_uneven_columns_are_refused_where_jax_refuses_them():
    """A model axis that does not divide a split dim (wq's 3 x 15 columns
    over 2): JAX's device_put of the leaves refuses it, and so does the
    port, naming the dim."""
    cfg = dict(model="llama-tiny", rules="tp_sp", **COMMON, batch_size=2,
               model_overrides={"n_heads": 3, "n_kv_heads": 1, "head_dim": 15})
    assert "should be divisible by 2" in _jax_error(cfg, _tp(model=2))
    with pytest.raises(ValueError, match=r"does not divide n_heads x head_dim \(45\)"):
        ttrainer.TrainConfig(**cfg).check_supported(
            Mesh(_tp(model=2), [0, 1], "cpu"))


def test_ulysses_beside_a_head_split_is_refused_naming_it():
    """Ring and zigzag run beside a head split (held above). Ulysses over
    3 heads at seq=2 is refused by the JAX Trainer, and the port raises
    its error; where the seq axis divides the heads (6 over 2) both
    Trainers run Ulysses on the whole heads (held above at model=4), so
    the port refuses nothing there."""
    cfg = dict(model="llama-tiny", rules="tp_sp", seq_parallel="ulysses", **COMMON,
               batch_size=2, model_overrides=THREE)
    tr = jtrainer.Trainer(jtrainer.TrainConfig(**cfg), axes=_tp(seq=2, model=2))
    tr.init_or_resume()
    with pytest.raises(ValueError) as jerr:
        tr.step_fn(tr.state, tr.place_batch(next(jtrainer.synthetic_batches(tr.cfg))))
    mesh = Mesh(_tp(seq=2, model=2), [0, 1, 2, 3], "cpu")
    with pytest.raises(ValueError) as terr:
        ttrainer.TrainConfig(**cfg).check_supported(mesh)
    assert str(terr.value) == str(jerr.value)
    six = Mesh(_tp(seq=2, model=4), list(range(8)), "cpu")
    ttrainer.TrainConfig(**{**cfg, "model_overrides": SIX}).check_supported(six)
    ttrainer.TrainConfig(**{**cfg, "seq_parallel": "ring"}).check_supported(mesh)
