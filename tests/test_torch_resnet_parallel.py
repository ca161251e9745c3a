"""ResNet-50 across ranks: the port's global batch norm and its meshed
Trainer held against one rank and against the JAX Trainer, on the CPU.

* ``resnet.param_logical_axes`` equals the JAX package's tree (conv
  kernels HWIO; ``held_logical_axes`` is its OIHW twin for the port's
  tensors).
* ``_batchnorm`` in training mode over a data axis of 2 gloo ranks
  (``tests/torch_parallel_worker.py``), each on its rows of an f32 batch,
  equals one rank on the whole batch: output and dx on the rank's rows,
  dscale and dbias summed over the ranks (the trainer's gradient sum),
  the running statistics on every rank. A per-rank batch norm (the
  statistics of the rank's rows alone) differs by far more.
* The Trainer on ResNet-50 (f32, image 32, batch 4, 10 classes, 2
  steps) over ``dp`` data=2, ``fsdp`` fsdp=2 (CONV_OUT over fsdp) and
  ``tp_sp`` model=2 (the head's classes over ``model``, whose ranks see
  the same images) against the JAX Trainer on the same axes from the same
  params and
  batches, replicas equal to the bit. The limits are
  tests/test_torch_parallel_train.py's (per-step loss 1e-4 absolute,
  grad_norm 1e-4 relative, the final params and the BN running
  statistics 2e-4), each widened to three times the spread of the
  references at this cell, which its conditioning sets far above them
  (the last stage normalizes 4 samples of 1x1, its variance taken in one
  f32 pass): the larger of the JAX Trainer's one-device run against its
  run on the same mesh (a loss 3.5e-3 apart at step 1, grad_norm 1.7%) and
  the port's one-device run against JAX's. The eval loss (about 41: the
  inference forward on running statistics still near their init, the
  cell's worst conditioned number) is held to 1e-3 relative. The per-rank
  batch norm planted in the data=2 run breaks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oim_tpu.models import resnet as jresnet
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.models import resnet as tresnet
from tests.torch_parallel_worker import Job

STEPS = 2
WORLD = 2
JOB_TIMEOUT = 600.0
LOSS_TOL, NORM_TOL, PARAM_TOL = 1e-4, 1e-4, 2e-4
COMMON = dict(model="resnet50", batch_size=4, image_size=32, num_classes=10, lr=1e-4,
              warmup_steps=2, total_steps=10, log_every=1, seed=5)
SCENARIOS = {"dp": ("dp", [("data", 2)]), "fsdp": ("fsdp", [("data", 1), ("fsdp", 2)]),
             # The head's classes over a model axis whose ranks see the same
             # images: its gather's backward keeps a slice, sums nothing.
             "tp_model": ("tp_sp", [("data", 1), ("fsdp", 1), ("seq", 1), ("model", 2)])}
BN_SHAPE = (8, 6, 5, 5)  # N, C, H, W


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_run(rules, axes, init, eval_batch):
    jcfg = jtrainer.TrainConfig(rules=rules, **COMMON, model_overrides={"dtype": jnp.float32})
    tr = jtrainer.Trainer(jcfg, axes=axes)
    tr.init_or_resume()
    for k, v in _flat(jax.tree.map(np.asarray, tr.state.params)).items():
        np.testing.assert_array_equal(v, init[k])
    data = jtrainer.synthetic_batches(jcfg)
    losses, norms = [], []
    for _ in range(STEPS):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "final": _flat(jax.tree.map(np.asarray, tr.state.params)),
            "extra": _flat(jax.tree.map(np.asarray, tr.state.extra)),
            "eval": tr.evaluate(iter([eval_batch]), 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resnet_parallel")
    jcfg = jtrainer.TrainConfig(**COMMON, model_overrides={"dtype": jnp.float32})
    first = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    first.init_or_resume()
    params = _flat(jax.tree.map(np.asarray, first.state.params))
    extra = _flat(jax.tree.map(np.asarray, first.state.extra))
    rng = np.random.RandomState(21)
    eval_batch = {"images": rng.rand(4, 32, 32, 3).astype(np.float32),
                  "labels": rng.randint(0, 10, (4,)).astype(np.int32)}
    bn = {"x": rng.randn(*BN_SHAPE).astype(np.float32) * 2 + 0.5,
          "g": rng.randn(*BN_SHAPE).astype(np.float32),
          "scale": rng.rand(BN_SHAPE[1]).astype(np.float32) + 0.5,
          "bias": rng.randn(BN_SHAPE[1]).astype(np.float32),
          "mean": rng.randn(BN_SHAPE[1]).astype(np.float32),
          "var": rng.rand(BN_SHAPE[1]).astype(np.float32) + 0.5}
    inputs = {**{f"params/{k}": v for k, v in params.items()},
              **{f"extra/{k}": v for k, v in extra.items()},
              **{f"bn/{k}": v for k, v in bn.items()}}
    scenarios = [{"type": "batchnorm", "name": "bn"}]
    cfg = dict(**COMMON, model_overrides={"dtype": "float32"})
    for name, (rules, axes) in {**SCENARIOS, "rank_bn": SCENARIOS["dp"]}.items():
        inputs[f"{name}/eval_images"] = eval_batch["images"]
        inputs[f"{name}/eval_labels"] = eval_batch["labels"]
        scenarios.append({"type": "train", "name": name, "axes": axes, "steps": STEPS,
                          "cfg": dict(rules=rules, **cfg),
                          "fault": "rank_bn" if name == "rank_bn" else None})
    job = Job(tmp, WORLD, inputs, scenarios, JOB_TIMEOUT)
    want = {name: _jax_run(rules, axes, params, eval_batch)
            for name, (rules, axes) in {**SCENARIOS, "one": ("dp", [("data", 1)])}.items()}
    want["port_one"] = _port_one(params, extra, eval_batch)
    return params, bn, job.results(), want


def _port_one(params, extra, eval_batch) -> dict:
    """The port's one-device run of the cell, in ``_jax_run``'s shape."""
    import torch

    from oim_tpu_torch.train import trainer as ttrainer

    tcfg = ttrainer.TrainConfig(**COMMON, model_overrides={"dtype": torch.float32})
    tr = ttrainer.Trainer(tcfg, device="cpu")
    unflat = lambda flat: {k: v for k, v in _unflatten(flat).items()}  # noqa: E731
    tr.init(tresnet.from_numpy(unflat(params), device="cpu"),
            tresnet.from_numpy(unflat(extra), device="cpu"))
    data = ttrainer.synthetic_batches(tcfg)
    r: dict = {}
    for i in range(STEPS):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        r[f"one/loss{i}"], r[f"one/grad_norm{i}"] = float(stats["loss"]), float(stats["grad_norm"])
    for k, v in _flat(tresnet.to_numpy(tr.state.params)).items():
        r[f"one/final/{k}"] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
    for k, v in _flat(tresnet.to_numpy(tr.state.extra)).items():
        r[f"one/extra/{k}"] = v
    r["one/eval_loss"] = tr.evaluate(iter([eval_batch]), 1)
    return _run_of(r, "one")


def _unflatten(flat: dict) -> dict:
    from tests.torch_parallel_worker import unflatten

    return unflatten(flat)


def test_logical_axes_match_jax():
    for cfg in ({}, {"num_classes": 10}):
        assert (tresnet.param_logical_axes(tresnet.Config(**cfg))
                == jresnet.param_logical_axes(jresnet.Config(**cfg)))
    held = tresnet.held_logical_axes()
    assert held["stem"] == ("conv_out", "conv_in", None, None)
    assert held["head"] == {"kernel": ("embed", "vocab"), "bias": ("vocab",)}


def _one_rank_bn(bn):
    import torch

    x = torch.tensor(bn["x"]).requires_grad_(True)
    p = {k: torch.tensor(bn[k]).requires_grad_(True) for k in ("scale", "bias")}
    s = {k: torch.tensor(bn[k]) for k in ("mean", "var")}
    y, new_s = tresnet._batchnorm(x, p, s, True, 0.9, 1e-5)
    y.backward(torch.tensor(bn["g"]))
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": p["scale"].grad.numpy(),
            "dbias": p["bias"].grad.numpy(), "mean": new_s["mean"].numpy(),
            "var": new_s["var"].numpy()}


@pytest.mark.parametrize("item", ["y", "dx", "dscale", "dbias", "mean", "var"])
def test_global_batchnorm_equals_one_rank_on_the_whole_batch(runs, item):
    _, bn, ranks, _ = runs
    want = _one_rank_bn(bn)[item]
    stats = item != "dbias"  # dbias is the cotangent's sum: no statistic in it
    if item in ("y", "dx"):  # each rank's rows
        got = np.concatenate([r[f"bn/global/{item}"] for r in ranks])
        own = np.concatenate([r[f"bn/own/{item}"] for r in ranks])
    elif item in ("dscale", "dbias"):  # summed over the ranks, as the trainer sums
        got = sum(r[f"bn/global/{item}"] for r in ranks)
        own = sum(r[f"bn/own/{item}"] for r in ranks)
    else:  # the same running statistics on every rank
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"bn/global/{item}"], ranks[0][f"bn/global/{item}"])
        got, own = ranks[0][f"bn/global/{item}"], ranks[0][f"bn/own/{item}"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if stats:  # the per-rank statistics differ
        assert np.abs(own - want).max() > 100 * 1e-5


def _run_of(r, name) -> dict:
    """One rank's run in the shape of ``_jax_run``'s (conv kernels HWIO)."""
    leaves = [k[len(f"{name}/final/"):] for k in r if k.startswith(f"{name}/final/")]
    extra = [k[len(f"{name}/extra/"):] for k in r if k.startswith(f"{name}/extra/")]

    def hwio(a):
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return {"losses": [float(r[f"{name}/loss{i}"]) for i in range(STEPS)],
            "norms": [float(r[f"{name}/grad_norm{i}"]) for i in range(STEPS)],
            "final": {k: hwio(r[f"{name}/final/{k}"]) for k in leaves},
            "extra": {k: r[f"{name}/extra/{k}"] for k in extra},
            "eval": float(r[f"{name}/eval_loss"])}


def _deviation(got: dict, want: dict) -> dict:
    return {
        "loss": max(abs(a - b) for a, b in zip(got["losses"], want["losses"])),
        "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(got["norms"], want["norms"])),
        "params": max(float(np.abs(got["final"][k] - w).max()) for k, w in want["final"].items()),
        "extra": max(float(np.abs(got["extra"][k] - w).max()) for k, w in want["extra"].items()),
        "eval": abs(got["eval"] - want["eval"]) / abs(want["eval"]),
    }


LIMITS = {"loss": LOSS_TOL, "grad_norm": NORM_TOL, "params": PARAM_TOL, "extra": PARAM_TOL}
EVAL_REL = 1e-3


def _bounds(want, name) -> dict:
    """Each limit, widened to 3x the references' spread: the JAX Trainer's
    run on ``name``'s mesh against its one-device run, and the port's
    one-device run against that."""
    jax_spread = _deviation(want[name], want["one"])
    port_spread = _deviation(want["port_one"], want["one"])
    return {**{k: max(LIMITS[k], 3 * jax_spread[k], 3 * port_spread[k]) for k in LIMITS},
            "eval": EVAL_REL}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trainer_matches_jax_trainer(runs, name):
    _, _, ranks, want = runs
    bounds = _bounds(want, name)
    for r in ranks:
        dev = _deviation(_run_of(r, name), want[name])
        assert all(dev[k] <= bounds[k] for k in bounds), sorted((k, dev[k], bounds[k]) for k in bounds)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_and_fsdp_pieces(runs, name):
    """Replicas equal to the bit after every step; under fsdp every conv
    kernel and BN vector is cut in two along its output channels, the head
    along its embed rows, and the BN running statistics stay whole; under
    model=2 only the head is cut, along its classes."""
    params, _, ranks, _ = runs
    for step in range(STEPS):
        for leaf in params:
            by_piece: dict = {}
            for r in ranks:
                by_piece.setdefault(tuple(r[f"{name}/piece/{leaf}"]), []).append(
                    r[f"{name}/shard{step}/{leaf}"])
            for pieces in by_piece.values():
                for other in pieces[1:]:
                    np.testing.assert_array_equal(other, pieces[0], err_msg=leaf)
    for r in ranks:
        for leaf, full in params.items():
            held = r[f"{name}/shard0/{leaf}"]
            split = 2 if ((name == "fsdp" and leaf != "head.bias")
                          or (name == "tp_model" and leaf.startswith("head."))) else 1
            assert held.size * split == full.size, leaf
            if held.ndim == 4:  # OIHW: the output channels lead
                assert held.shape[0] * split == full.shape[3], leaf


def test_per_rank_batchnorm_breaks_the_limits(runs):
    _, _, ranks, want = runs
    bounds = _bounds(want, "dp")
    worst = {k: max(_deviation(_run_of(r, "rank_bn"), want["dp"])[k] for r in ranks)
             for k in bounds}
    assert any(worst[k] > bounds[k] for k in bounds), (worst, bounds)
