"""The rest of the port's trainer, on the CPU: host augmentation against
the JAX package's, the checkpointer, resume, remat, the profiler wrapper
and the trainer CLI's flags against the JAX CLI's.

Resume and remat are held to the port's own uninterrupted, remat-free run
exactly (bit for bit): the same torch ops on the same inputs, on the CPU.
"""

import dataclasses
import importlib
import itertools
import json
import os

import numpy as np
import pytest
import torch

from oim_tpu.cli import oim_trainer as jcli
from oim_tpu.data import augment as jaugment
from oim_tpu_torch.cli import oim_trainer as tcli
from oim_tpu_torch.common.profiling import profile_trace
from oim_tpu_torch.data import augment as taugment
from oim_tpu_torch.data.feeds import SeekableFeed
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.models import resnet as tresnet
from oim_tpu_torch.train import state as tstate
from oim_tpu_torch.train import trainer as ttrainer
from oim_tpu_torch.train.checkpoint import Checkpointer

# the module (ops/__init__ exports the function under the same name)
attention_module = importlib.import_module("oim_tpu_torch.ops.attention")

torch.set_num_threads(2)

TINY = {
    "llama-tiny": dict(model="llama-tiny", batch_size=2, seq_len=16),
    # the whole ResNet-50 at a small image (the stage widths are fixed)
    "resnet50": dict(model="resnet50", batch_size=2, image_size=32, num_classes=10,
                     model_overrides={"dtype": torch.float32}),
}


def _cfg(model, **kw):
    return ttrainer.TrainConfig(**TINY[model], lr=1e-3, warmup_steps=1, total_steps=10,
                                log_every=1, seed=3, **kw)


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same_state(a: tstate.TrainState, b: tstate.TrainState) -> bool:
    trees = [(a.params, b.params), (a.extra, b.extra), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    for x, y in trees:
        xs, ys = list(tstate.tree_leaves(x)), list(tstate.tree_leaves(y))
        if len(xs) != len(ys):
            return False
        for s, t in zip(xs, ys):
            if s.dtype != t.dtype or s.shape != t.shape or s.stride() != t.stride() \
                    or _bytes(s) != _bytes(t):
                return False
    return a.step == b.step and a.opt_state.count == b.opt_state.count


# ---------------------------------------------------------- augmentation --


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_augment_equals_jax(dtype):
    rs = np.random.RandomState(0)
    images = (rs.rand(5, 12, 10, 3) * 255).astype(dtype)
    got = taugment.augment_images(images, np.random.RandomState(7))
    want = jaugment.augment_images(images, np.random.RandomState(7))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    batches = [{"images": images, "labels": np.arange(5)}, {"tokens": np.ones(3)}]
    for g, w in zip(taugment.augment_batches(iter(batches), seed=2, crop_pad=2),
                    jaugment.augment_batches(iter(batches), seed=2, crop_pad=2)):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------- checkpointer --


def _state(seed=0, step=12):
    g = torch.Generator().manual_seed(seed)
    conv = torch.randn(8, 3, 3, 3, generator=g).to(torch.bfloat16)
    params = {"conv": conv.contiguous(memory_format=torch.channels_last),
              "w": torch.randn(4, 5, generator=g), "b": {"i": torch.arange(6, dtype=torch.int32)}}
    tx = tstate.make_optimizer()
    opt = tx.init(params)
    opt.count = 7
    for t in tstate.tree_leaves(opt.mu):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    extra = {"bn": {"mean": torch.randn(3, generator=g), "var": torch.rand(3, generator=g)}}
    return tstate.TrainState(step=step, params=params, opt_state=opt, extra=extra)


def test_checkpoint_round_trip_keeps_every_byte(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path))
    ck.save(12, state, wait=True)
    back = ck.restore()
    assert _same_state(state, back)
    assert back.params["conv"].is_contiguous(memory_format=torch.channels_last)
    assert ck.latest_step() == 12 and sorted(os.listdir(tmp_path)) == ["12"]


def test_save_snapshots_before_the_step_updates_in_place(tmp_path):
    state = _state()
    want = [t.clone() for t in tstate.tree_leaves(state.params)]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)  # in the background
    for t in tstate.tree_leaves(state.params):
        t.add_(1)
    ck.close()
    got = list(tstate.tree_leaves(ck.restore(1).params))
    assert all(_bytes(a) == _bytes(b) for a, b in zip(want, got))


def test_checkpointer_keeps_the_newest_max_to_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, _state(step))
    ck.close()
    assert ck.all_steps() == [3, 4]
    assert ck.restore(3).params["w"].equal(_state(3).params["w"])


def test_saving_a_step_again_replaces_it(tmp_path):
    """It does not: as orbax's manager does, a step at or below the
    latest one on disk is skipped, and the copy there stays."""
    ck = Checkpointer(str(tmp_path))
    assert ck.save(5, _state(0, step=5), wait=True)
    assert not ck.save(5, _state(1, step=5), wait=True)
    assert not ck.save(4, _state(1, step=4))
    ck.close()
    assert _same_state(_state(0, step=5), ck.restore(5))
    assert sorted(os.listdir(tmp_path)) == ["5"]


def test_a_run_resumed_at_its_last_step_writes_no_checkpoint(tmp_path):
    cfg = _cfg("llama-tiny", checkpoint_dir=str(tmp_path), checkpoint_every=2)
    ttrainer.Trainer(cfg, device="cpu").run(steps=2)
    saved = tmp_path / "2" / "state.pt"
    before = saved.stat()
    again = ttrainer.Trainer(cfg, device="cpu")
    again.run(steps=2)
    assert again.state.step == 2 and again.history == []
    after = saved.stat()
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns)
    assert sorted(os.listdir(tmp_path)) == ["2"]


def test_a_leftover_temporary_directory_is_ignored(tmp_path):
    """A save cut before its rename leaves only a temporary directory."""
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _state(step=3), wait=True)
    partial = tmp_path / ".tmp-9-123"
    partial.mkdir()
    (partial / "state.pt").write_bytes(b"cut off")
    (tmp_path / "10").mkdir()  # a final name with no state file
    assert ck.latest_step() == 3
    assert _same_state(_state(step=3), ck.restore())


def test_restore_without_a_checkpoint_raises(tmp_path):
    ck = Checkpointer(str(tmp_path / "none"))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()


# ---------------------------------------------------------------- resume --


@pytest.mark.parametrize("feed", ["seek", "replay"])
@pytest.mark.parametrize("model", ["llama-tiny", "resnet50"])
def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, model, feed):
    cfg = _cfg(model)
    whole = ttrainer.Trainer(cfg, device="cpu")
    whole.run(steps=4)

    starts = []

    def make(start):
        starts.append(start)
        return itertools.islice(ttrainer.synthetic_batches(cfg), start, None)

    def data():
        return SeekableFeed(make) if feed == "seek" else None  # None: the replayed default

    ckpt = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    first = ttrainer.Trainer(_cfg(model, **ckpt), device="cpu")
    first.run(steps=2, data=data())
    resumed = ttrainer.Trainer(_cfg(model, **ckpt), device="cpu")
    resumed.run(steps=4, data=data())
    assert [r["step"] for r in resumed.history] == [3, 4]
    assert [r["loss"] for r in resumed.history] == [r["loss"] for r in whole.history[2:]]
    assert _same_state(whole.state, resumed.state)
    assert resumed.checkpointer.all_steps() == [2, 4]
    if feed == "seek":
        assert starts == [0, 2]  # the resumed feed was repositioned, not replayed


def test_init_or_resume_returns_the_step(tmp_path):
    cfg = _cfg("llama-tiny", checkpoint_dir=str(tmp_path), checkpoint_every=3)
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert tr.init_or_resume() == 0
    tr.run(steps=3)
    again = ttrainer.Trainer(cfg, device="cpu")
    assert again.init_or_resume() == 3 and again.state.step == 3
    assert all(p.requires_grad for p in tstate.tree_leaves(again.state.params))
    assert _same_state(tr.state, again.state)


def test_a_feed_too_short_to_fast_forward_raises(tmp_path):
    cfg = _cfg("llama-tiny", checkpoint_dir=str(tmp_path), checkpoint_every=2)
    ttrainer.Trainer(cfg, device="cpu").run(steps=2)
    with pytest.raises(RuntimeError, match="fast-forwarding"):
        ttrainer.Trainer(cfg, device="cpu").run(
            steps=4, data=iter(list(itertools.islice(ttrainer.synthetic_batches(cfg), 1))))


# ------------------------------------------------------------------ eval --


def test_run_evaluates_on_the_held_out_stream_and_keeps_it_out_of_step_s():
    tr = ttrainer.Trainer(_cfg("llama-tiny", eval_every=2, eval_steps=2), device="cpu")
    tr.run(steps=4)
    evals = [r for r in tr.history if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert [r["step"] for r in tr.history if "loss" in r] == [1, 2, 3, 4]
    assert tr.last_eval_stats["loss"] == evals[-1]["eval_loss"]
    # the held-out stream is the synthetic one at seed + 10 000, read on
    # from pass to pass: the second pass evaluates its batches 3-4
    other = ttrainer.Trainer(_cfg("llama-tiny"), device="cpu")
    other.state = tr.state
    held_out = ttrainer.synthetic_batches(dataclasses.replace(_cfg("llama-tiny"), seed=10_003))
    assert other.evaluate(itertools.islice(held_out, 2, None), 2) == evals[-1]["eval_loss"]


def test_a_real_feed_without_eval_data_skips_eval():
    cfg = _cfg("llama-tiny", eval_every=1)
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.run(steps=2, data=iter(list(itertools.islice(ttrainer.synthetic_batches(cfg), 2))))
    assert not any("eval_loss" in r for r in tr.history) and tr.last_eval_stats == {}


# ----------------------------------------------------------------- remat --


def _loss_and_grads(model, cfg_kw, counts=None):
    tcfg = _cfg(model, **cfg_kw)
    mcfg = tcfg.model_config()
    batch = next(ttrainer.synthetic_batches(tcfg))
    g = torch.Generator().manual_seed(0)
    if model == "resnet50":
        params, extra = tresnet.init(g, mcfg, device="cpu")
    else:
        params, extra = tllama.init(g, mcfg, device="cpu"), {}
    leaves = list(tstate.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    if model == "resnet50":
        logits, new_extra = tresnet.apply(params, extra, torch.from_numpy(batch["images"]),
                                          mcfg, training=True)
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(batch["labels"]).long())
    else:
        loss, new_extra = tllama.loss_fn(params, torch.from_numpy(batch["tokens"]), mcfg), {}
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, new_extra


@pytest.mark.parametrize("policy", ["", "nothing", "dots", "dots_with_no_batch_dims"])
def test_llama_remat_changes_no_loss_or_gradient(policy, monkeypatch):
    calls = {"fwd": 0, "dkv": 0}
    fwd, dkv = attention_module.flash_forward_plain, attention_module.flash_bwd_dkv_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(attention_module, "flash_forward_plain", count("fwd", fwd))
    monkeypatch.setattr(attention_module, "flash_bwd_dkv_plain", count("dkv", dkv))
    loss, grads, _ = _loss_and_grads("llama-tiny", {})
    plain = dict(calls)
    rloss, rgrads, _ = _loss_and_grads("llama-tiny", {"remat": True, "remat_policy": policy})
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    layers = tllama.tiny().n_layers
    # the forward runs again in the backward; the backward does not
    assert plain == {"fwd": layers, "dkv": layers}
    assert calls == {"fwd": 3 * layers, "dkv": 2 * layers}


def test_resnet_remat_changes_no_loss_gradient_or_bn_state():
    loss, grads, extra = _loss_and_grads("resnet50", {})
    rloss, rgrads, rextra = _loss_and_grads("resnet50", {"remat": True})
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    assert all(torch.equal(a, b) for a, b in zip(tstate.tree_leaves(extra),
                                                 tstate.tree_leaves(rextra)))


def test_remat_step_updates_the_bn_statistics_once():
    """The recomputed blocks' new state is dropped: one remat step leaves
    the running statistics where one plain step does, one momentum update
    from their init."""
    states = []
    for remat in (False, True):
        tr = ttrainer.Trainer(_cfg("resnet50", remat=remat), device="cpu")
        tr.init()
        tr.state, _ = tr.step_fn(tr.state, tr.place_batch(next(
            ttrainer.synthetic_batches(tr.cfg))))
        states.append(tr.state)
    plain, remat = states
    assert _same_state(plain, remat)
    x = torch.from_numpy(next(ttrainer.synthetic_batches(_cfg("resnet50")))["images"])
    stem = tresnet.conv_same(x.permute(0, 3, 1, 2), tresnet.init(
        torch.Generator().manual_seed(3), _cfg("resnet50").model_config(), "cpu")[0]["stem"], 2)
    mean = stem.mean(dim=(0, 2, 3))
    torch.testing.assert_close(remat.extra["bn_stem"]["mean"], 0.1 * mean, rtol=1e-5, atol=1e-7)


def test_unknown_policy_and_policy_without_remat_raise():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ttrainer.Trainer(_cfg("llama-tiny", remat=True, remat_policy="all"), device="cpu")
    with pytest.raises(ValueError, match="remat_policy without remat"):
        ttrainer.Trainer(_cfg("llama-tiny", remat_policy="dots"), device="cpu")
    with pytest.raises(ValueError, match="does not support remat_policy"):
        ttrainer.Trainer(_cfg("resnet50", remat=True, remat_policy="dots"), device="cpu")


# -------------------------------------------------------------- profiling --


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "prof"
    with profile_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((out / files[0]).read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_profile_trace_of_no_directory_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profile_trace(""):
        pass
    with profile_trace(None):
        pass
    assert os.listdir(tmp_path) == []


# -------------------------------------------------------------------- CLI --


NEW_FLAGS = ["--model", "resnet50", "--image-size", "48", "--num-classes", "17",
             "--remat", "--checkpoint-dir", "ck", "--checkpoint-every", "5",
             "--eval-every", "3", "--eval-steps", "2", "--steps", "9", "--batch-size", "4",
             "--warmup-steps", "2", "--log-every", "3", "--lr", "0.01", "--accum-steps", "2"]


@pytest.mark.parametrize("argv", [
    NEW_FLAGS,
    ["--model", "llama-tiny", "--remat", "--remat-policy", "dots_with_no_batch_dims",
     "--model-override", "n_layers=3", "--model-override", "z_loss=0.5", "--seq-len", "32"],
    ["--model", "llama3-8b", "--remat", "--remat-policy", "nothing"],
], ids=["resnet50", "llama-tiny", "llama3-8b"])
def test_cli_flags_give_the_jax_clis_train_config(argv, monkeypatch):
    """The JAX CLI's TrainConfig is caught where it builds its Trainer."""
    seen = {}

    class Catch:
        def __init__(self, cfg, **kw):
            seen["cfg"] = cfg

        def run(self, **kw):
            return 0.0

    monkeypatch.setattr(jcli, "Trainer", Catch)
    jcli.main(argv + ["--log-level", "error"])
    want, got = seen["cfg"], tcli.config_from_args(tcli.parse_args(argv))
    for name in ("model", "remat", "remat_policy", "accum_steps", "batch_size", "seq_len",
                 "image_size", "num_classes", "lr", "warmup_steps", "total_steps",
                 "log_every", "checkpoint_dir", "checkpoint_every", "eval_every",
                 "eval_steps", "model_overrides", "rules", "seed", "weight_decay"):
        assert getattr(got, name) == getattr(want, name), name


def test_cli_trains_resnet50_on_cpu_with_every_new_flag(tmp_path):
    argv = ["--model", "resnet50", "--device", "cpu", "--steps", "2", "--batch-size", "2",
            "--image-size", "32", "--num-classes", "10", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1",
            "--eval-every", "2", "--eval-steps", "1", "--augment", "--remat",
            "--profile", str(tmp_path / "prof"), "--log-level", "error"]
    tr = tcli.run(argv)
    assert tr.state.step == 2 and tr.cfg.model_config().remat
    assert [r["step"] for r in tr.history if "loss" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in tr.history if "loss" in r)
    assert 0.0 <= tr.last_eval_stats["accuracy"] <= 1.0
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [1, 2]
    assert len(os.listdir(tmp_path / "prof")) == 1
    # the same command again resumes at the end and trains no further
    again = tcli.run(argv[:argv.index("--profile")] + ["--log-level", "error"])
    assert again.state.step == 2 and again.history == []
