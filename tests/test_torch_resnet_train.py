"""The port's trainer on resnet50 held against the JAX package's Trainer
on the CPU: the same weights (JAX's init carried across with
from_numpy), the same synthetic batches, f32 through ``model_overrides``,
batch 8, 10 classes, on one device.

The image is 64x64, not the 32x32 of ``tests/test_train.py``'s ResNet
cell: at 32x32 the last stage normalizes over 8 samples (1x1 spatial),
which amplifies the two packages' f32 rounding differences most (see
tests/test_torch_resnet.py); at 64x64 it normalizes over 32.

Tolerances: the losses of steps 1-2 1e-4 relative (read: 2e-5; step 1's
update runs at lr 0, so both are forwards of the initial weights);
step 3's 1e-2 (read: 3e-3). Step 3 follows the first real Adam update,
whose normalized steps turn the f32 gradient differences that
tests/test_torch_resnet.py measures against JAX's f64 evaluation into
sign flips of single elements. Eval of one state: loss 1e-5 relative,
the same accuracy.

Each param leaf's change over the 3 steps (after minus init) is held to
JAX's by relative L2, the worst leaf within 0.4. Adam divides every
element's update by its own gradient scale, so elements with small
gradients carry the f32 differences in full: the port reads 0.28 against
JAX (0.18 over all leaves at once), and 0.26 against its own f64 run of
the same 3 steps. The controls fail the limit: no update at all reads 1,
step 3's update left out (the state after step 2) reads 0.67.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.ops import losses as jlosses
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.models import resnet as tresnet
from oim_tpu_torch.ops.losses import accuracy as taccuracy
from oim_tpu_torch.train import trainer as ttrainer
from oim_tpu_torch.train.state import tree_leaves

torch.set_num_threads(2)

COMMON = dict(model="resnet50", batch_size=8, image_size=64, num_classes=10, warmup_steps=2,
              total_steps=10, log_every=1, seed=5)
UPDATE_TOL = 0.4


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name in tree for k, v in _leaves(tree[name], f"{prefix}/{name}").items()}
    return {prefix: np.asarray(tree, np.float64)}


def _rel_l2(ref, got) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _cfgs(**kw):
    return (jtrainer.TrainConfig(**COMMON, model_overrides={"dtype": jnp.float32}, **kw),
            ttrainer.TrainConfig(**COMMON, model_overrides={"dtype": torch.float32}, **kw))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer's initial state, per-step losses and state after 3
    steps, and its eval of that state over 2 held-out batches."""
    jcfg, _ = _cfgs()
    tr = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    tr.init_or_resume()
    init = jax.tree.map(np.asarray, (tr.state.params, tr.state.extra))
    data = jtrainer.synthetic_batches(jcfg)
    losses = []
    for _ in range(3):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
    after = jax.tree.map(np.asarray, (tr.state.params, tr.state.extra))
    eval_cfg = dataclasses.replace(jcfg, seed=jcfg.seed + 10_000)
    tr.evaluate(jtrainer.synthetic_batches(eval_cfg), 2)
    return {"init": init, "losses": losses, "after": after,
            "eval": dict(tr.last_eval_stats)}


def test_resnet_losses_match_jax_trainer(jax_run):
    _, tcfg = _cfgs()
    tr = ttrainer.Trainer(tcfg, device="cpu")
    params, extra = jax_run["init"]
    tr.init(tresnet.from_numpy(params, device="cpu"), tresnet.from_numpy(extra, device="cpu"))
    data = ttrainer.synthetic_batches(tcfg)
    tr.run(steps=2, data=data)
    after_2 = tresnet.to_numpy(tr.state.params)
    last = tr.run(steps=3, data=data)
    losses = [r["loss"] for r in tr.history]
    np.testing.assert_allclose(losses[:2], jax_run["losses"][:2], rtol=1e-4)
    np.testing.assert_allclose(losses[2], jax_run["losses"][2], rtol=1e-2)
    assert last == losses[-1] and tr.state.step == 3
    # the BN running statistics moved, and carry no gradient
    assert not torch.equal(tr.state.extra["bn_stem"]["mean"], torch.zeros(64))
    assert all(not t.requires_grad for t in tree_leaves(tr.state.extra))
    _, jextra = jax_run["after"]
    for got, want in zip(tree_leaves(tr.state.extra["bn_stem"]),
                         tree_leaves(jextra["bn_stem"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-4)
    # Each leaf's change over the 3 steps against JAX's (see the module
    # docstring); the two controls must fail the limit.
    jparams = _leaves(jax_run["after"][0])
    init = _leaves(params)

    def worst(got):
        got = _leaves(got)
        return max(_rel_l2(jparams[k] - init[k], got[k] - init[k]) for k in init)

    assert worst(tresnet.to_numpy(tr.state.params)) <= UPDATE_TOL
    assert worst(after_2) > UPDATE_TOL and worst(params) == 1.0


def test_evaluate_matches_jax_and_leaves_the_state(jax_run):
    """Both packages evaluate the same state (JAX's after 3 steps)."""
    jcfg, tcfg = _cfgs()
    tr = ttrainer.Trainer(tcfg, device="cpu")
    params, extra = jax_run["after"]
    tr.init(tresnet.from_numpy(params, device="cpu"), tresnet.from_numpy(extra, device="cpu"))
    before = [t.clone() for t in tree_leaves(tr.state.extra)]
    eval_cfg = dataclasses.replace(tcfg, seed=tcfg.seed + 10_000)
    loss = tr.evaluate(ttrainer.synthetic_batches(eval_cfg), 2)
    want = jax_run["eval"]
    assert set(tr.last_eval_stats) == set(want) == {"loss", "accuracy"}
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    assert tr.last_eval_stats["loss"] == loss
    assert tr.last_eval_stats["accuracy"] == pytest.approx(want["accuracy"], abs=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.state.extra)))
    assert tr.state.step == 0  # evaluation applies no update


def test_evaluate_of_an_empty_feed_is_nan():
    _, tcfg = _cfgs()
    tr = ttrainer.Trainer(tcfg, device="cpu")
    tr.init()
    assert np.isnan(tr.evaluate(iter([]), 2)) and tr.last_eval_stats == {}


def test_image_batches_and_flops_match_jax():
    jcfg, tcfg = _cfgs()
    jb, tb = jtrainer.synthetic_batches(jcfg), ttrainer.synthetic_batches(tcfg)
    for _ in range(3):
        j, t = next(jb), next(tb)
        assert j.keys() == t.keys() == {"images", "labels"}
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])
    full = dict(model="resnet50", batch_size=128)
    for kw in (full, dict(COMMON)):
        assert (ttrainer.flops_per_step(ttrainer.TrainConfig(**kw))
                == jtrainer.flops_per_step(jtrainer.TrainConfig(**kw)))
    assert ttrainer.flops_per_step(ttrainer.TrainConfig(**full)) == 3 * 4.1e9 * 128


@pytest.mark.parametrize("kw", [
    {}, {"remat": True}, {"num_classes": 7}, {"model_overrides": {"stem_s2d": True}},
    {"remat": True, "remat_policy": "dots"}, {"remat_policy": "dots"},
    {"model": "llama-tiny", "remat": True, "remat_policy": "dots_with_no_batch_dims"},
    {"model": "llama-tiny", "remat_policy": "nothing"}], ids=str)
def test_model_config_follows_jax(kw):
    """The same configs, and the same ValueErrors for a policy without
    remat and for a policy on ResNet."""
    kw = {"model": "resnet50", **kw}
    jcfg, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    try:
        want = jcfg.model_config()
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).split(" ")[0]):
            tcfg.model_config()
        return
    got = tcfg.model_config()
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_accuracy_matches_jax():
    rs = np.random.RandomState(9)
    logits = rs.randn(64, 10).astype(np.float32)
    labels = rs.randint(0, 10, 64).astype(np.int32)
    labels[:8] = logits[:8].argmax(-1)  # some hits
    want = float(jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = taccuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and float(got) == want


def test_peak_hbm_table_is_keyed_on_the_cuda_device_name():
    assert ttrainer.peak_hbm_bw_per_device("cpu") == 0.0
    assert dict(ttrainer.PEAK_HBM_BW)["h100"] == 3.35e12
    assert [k for k, _ in ttrainer.PEAK_HBM_BW] == [k for k, _ in ttrainer.PEAK_FLOPS]
