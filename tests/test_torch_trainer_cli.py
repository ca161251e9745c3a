"""The trainer CLI's ``--smoke`` and ``--synthetic`` (``oim_tpu/cli/
oim_trainer.py``) in the port, held against the JAX CLI on the CPU.

``--smoke`` trains llama-tiny for at most 5 steps of batch 2 and 32
tokens, logging every step, on ``data=`` the smaller of the batch and the
devices (the JAX CLI's fake CPU devices; the port's one process). Both
CLIs start from the same params (the JAX Trainer's init, carried by
``from_numpy``) and draw the same synthetic batches, so their losses agree
within 2e-5 at fp32. ``--synthetic`` names the default source.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from oim_tpu.cli import oim_trainer as jcli
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.cli import oim_trainer as tcli
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.models import llama
from oim_tpu_torch.train import trainer as ttrainer


@pytest.fixture
def jax_run(monkeypatch):
    """The JAX CLI's --smoke run: (its Trainer's initial params as numpy,
    its losses)."""
    made = []
    real = jtrainer.Trainer

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def init_or_resume(self):
            step = super().init_or_resume()
            self.first_params = jax.tree.map(np.asarray, self.state.params)
            self.losses = []
            step_fn = self.step_fn

            def recorded(state, batch):
                state, stats = step_fn(state, batch)
                self.losses.append(float(stats["loss"]))
                return state, stats

            self.step_fn = recorded
            return step

    monkeypatch.setattr(jcli, "Trainer", Recording)
    assert jcli.main(["--smoke", "--steps", "2", "--log-level", "error"]) == 0
    (tr,) = made
    return tr.first_params, tr.losses


def _port_run(monkeypatch, params, argv):
    made = []
    real_init = ttrainer.Trainer.init

    def init(self, params_=None, extra=None):
        real_init(self, llama.from_numpy(params, device="cpu"), extra)
        made.append(self)

    monkeypatch.setattr(ttrainer.Trainer, "init", init)
    prev = tlogging.get_global()
    try:
        assert tcli.main(argv) == 0
    finally:
        tlogging.set_global(prev)
    (tr,) = made
    return tr


def test_smoke_matches_the_jax_cli(jax_run, monkeypatch):
    params, jlosses = jax_run
    tr = _port_run(monkeypatch, params,
                   ["--smoke", "--steps", "2", "--device", "cpu", "--log-level", "error"])
    cfg = tr.cfg
    assert (cfg.model, cfg.total_steps, cfg.batch_size, cfg.seq_len, cfg.log_every) == \
        ("llama-tiny", 2, 2, 32, 1)
    tlosses = [r["loss"] for r in tr.history if "loss" in r]
    assert len(tlosses) == len(jlosses) == 2
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)


def test_smoke_caps_what_the_jax_cli_caps(monkeypatch):
    """--smoke overrides the model and caps steps, batch and sequence, as
    the JAX CLI does, and leaves a given --mesh alone."""
    args = tcli.parse_args(["--smoke", "--model", "llama3-8b", "--steps", "50",
                            "--batch-size", "16", "--seq-len", "2048"])
    assert (args.model, args.steps, args.batch_size, args.seq_len, args.log_every,
            args.mesh) == ("llama-tiny", 5, 2, 32, 1, "data=1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tcli.parse_args(["--smoke"]).mesh == "data=2"
    assert tcli.parse_args(["--smoke", "--mesh", "fsdp=4"]).mesh == "fsdp=4"


def test_synthetic_is_the_default_source():
    """--synthetic parses in both CLIs and changes nothing: without
    --registry both train on synthetic batches."""
    plain, synthetic = tcli.parse_args([]), tcli.parse_args(["--synthetic"])
    assert synthetic.synthetic and not plain.synthetic
    assert tcli.config_from_args(plain) == tcli.config_from_args(synthetic)
