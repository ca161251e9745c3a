"""The port's training (oim_tpu_torch.train) held against the JAX
package's, on the CPU: the optimizer against optax step for step, and a
short llama-tiny Trainer run against the JAX Trainer from the same weights
and the same synthetic batches.

Tolerances (fp32): optimizer params 1e-6 absolute after 20 steps (the same
elementwise arithmetic, rounded at the same places); trainer losses 1e-4
absolute over 10 steps (the two frameworks' matmuls sum in different
orders, and Adam's normalized update carries those last-bit differences
into the next step's loss).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oim_tpu.train import state as jstate
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.cli import oim_trainer as tcli
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.train import state as tstate
from oim_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)


def _tree(seed, shapes):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


@pytest.mark.parametrize("grad_scale", [0.05, 5.0])
def test_make_optimizer_matches_optax_over_20_steps(grad_scale):
    """grad_scale 5 keeps the global norm above 1 (every step clipped),
    0.05 keeps it below (never clipped). warmup 4 of 20 covers the linear
    ramp from lr 0, the cosine decay and its floor."""
    kw = dict(lr=1e-2, warmup_steps=4, total_steps=12, weight_decay=0.1)
    jtx = jstate.make_optimizer(**kw)
    ttx = tstate.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in _tree(0, SHAPES).items()}
    tp = {k: torch.tensor(v) for k, v in _tree(0, SHAPES).items()}
    jopt, topt = jtx.init(jp), ttx.init(tp)
    for step in range(20):
        g = {k: v * grad_scale for k, v in _tree(100 + step, SHAPES).items()}
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        norm = ttx.update({k: torch.tensor(v) for k, v in g.items()}, topt, tp)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=f"step {step + 1} leaf {k}")
    assert topt.count == 20


def test_first_update_runs_at_lr_zero():
    """optax evaluates the schedule at the pre-increment count: with a
    warmup from 0 the first update leaves the params where they were."""
    tx = tstate.make_optimizer(lr=1.0, warmup_steps=5, total_steps=10, weight_decay=0.1)
    p = {"w": torch.ones(3)}
    opt = tx.init(p)
    tx.update({"w": torch.full((3,), 7.0)}, opt, p)
    assert torch.equal(p["w"], torch.ones(3))
    tx.update({"w": torch.full((3,), 7.0)}, opt, p)
    assert not torch.equal(p["w"], torch.ones(3))


def test_moments_keep_param_dtype():
    tx = tstate.make_optimizer()
    opt = tx.init({"w": torch.zeros(4, dtype=torch.bfloat16), "n": torch.zeros(4)})
    assert opt.mu["w"].dtype == torch.bfloat16 and opt.nu["w"].dtype == torch.bfloat16
    assert opt.mu["n"].dtype == torch.float32


def _cfgs(**kw):
    common = dict(model="llama-tiny", batch_size=4, seq_len=16, lr=1e-2, warmup_steps=2,
                  total_steps=10, log_every=1, seed=3, **kw)
    return jtrainer.TrainConfig(**common), ttrainer.TrainConfig(**common)


def _jax_losses(jcfg, steps):
    """The JAX Trainer's state and its per-step losses on one device."""
    tr = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    tr.init_or_resume()
    init_params = jax.tree.map(np.asarray, tr.state.params)
    data = jtrainer.synthetic_batches(jcfg)
    losses = []
    for _ in range(steps):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
    return init_params, losses


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_trainer_losses_match_jax_trainer(accum_steps):
    jcfg, tcfg = _cfgs(accum_steps=accum_steps)
    init_params, jlosses = _jax_losses(jcfg, 10)
    tr = ttrainer.Trainer(tcfg, device="cpu")
    tr.init(tllama.from_numpy(init_params, device="cpu"))
    last = tr.run(steps=10)
    tlosses = [r["loss"] for r in tr.history]
    assert [r["step"] for r in tr.history] == list(range(1, 11))
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4)
    assert last == tlosses[-1]
    assert tlosses[-1] < tlosses[0]  # it trains
    for r in tr.history:
        assert r["mfu"] == 0.0 and r["step_s"] > 0 and np.isfinite(r["grad_norm"])


def test_synthetic_batches_and_flops_match_jax():
    jcfg, tcfg = _cfgs()
    jb, tb = jtrainer.synthetic_batches(jcfg), ttrainer.synthetic_batches(tcfg)
    for _ in range(3):
        np.testing.assert_array_equal(next(jb)["tokens"], next(tb)["tokens"])
    assert ttrainer.flops_per_step(tcfg) == jtrainer.flops_per_step(jcfg)
    big = dict(model="llama3-8b", seq_len=2048, batch_size=2,
               model_overrides={"n_layers": 2})
    assert (ttrainer.flops_per_step(ttrainer.TrainConfig(**big))
            == jtrainer.flops_per_step(jtrainer.TrainConfig(**big)))
    assert ttrainer.TrainConfig(**big).model_config() == dataclasses.replace(
        tllama.LLAMA3_8B, n_layers=2)


def test_peak_flops_table_is_keyed_on_the_cuda_device_name():
    assert ttrainer.peak_flops_per_device("cpu") == 0.0
    assert dict(ttrainer.PEAK_FLOPS)["h100"] == 989e12


def test_unported_trainer_options_refuse():
    for kw in ({"rules": "fsdp"}, {"model": "resnet50"},
               {"model_overrides": {"n_experts": 4}}, {"model_overrides": {"remat": True}}):
        with pytest.raises((NotImplementedError, ValueError)):
            ttrainer.Trainer(ttrainer.TrainConfig(**kw), device="cpu")


def test_entry_points_default_to_cuda():
    """Given no device, the port selects cuda: on a machine without one
    that is a clear error, never a silent CPU run."""
    assert tcli.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(ttrainer.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--steps", "1"])


def test_cli_runs_on_cpu_when_asked():
    tr = tcli.run(["--model", "llama-tiny", "--device", "cpu", "--steps", "2",
                   "--batch-size", "2", "--seq-len", "8", "--log-every", "1",
                   "--override", "n_layers=1", "--log-level", "error"])
    assert tr.state.step == 2 and len(tr.history) == 2
    assert tr.cfg.model_config().n_layers == 1
