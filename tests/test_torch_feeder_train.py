"""The port's trainer fed through the control plane, held against the JAX
package's: registry (JAX's, in process), controller and feeder.

* ``feeder_batches`` gives JAX's batches, token for token: a whole volume
  with and without ``--shuffle``, a window that cuts records and wraps
  the volume, the windowed reservoir shuffle, ``--prefetch-batches 2``,
  and a ``SeekableFeed`` resume.
* ``windowed_batches`` over ``controller.backend.read_window`` (the card's
  path, without a Feeder) gives the Feeder's batches.
* ``oim_trainer.main([... "--registry", ..., "--volume-file", ...])``
  trains llama-tiny at fp32 for 3 steps, whole-volume and windowed, to the
  JAX ``Trainer``'s losses on the JAX feed's batches within 2e-5.
* The refusals that fire before any RPC: a TFRecord volume for a llama
  model (JAX's message), ``--registry`` under several ranks without
  ``--expected-hosts``, and no ``--controller-id``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import time

import jax
import numpy as np
import pytest
import torch

from oim_tpu.controller import controller as jcontroller
from oim_tpu.controller.malloc_backend import MallocBackend as JMallocBackend
from oim_tpu.data import feeds as jfeeds
from oim_tpu.data.prefetch import prefetch_batches as jprefetch
from oim_tpu.data.shuffle import shuffle_batches as jshuffle
from oim_tpu.feeder import driver as jdriver
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.cli import oim_trainer as tcli
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.controller import CUDABackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.controller.backend import read_window
from oim_tpu_torch.data import feeds as tfeeds
from oim_tpu_torch.data.prefetch import prefetch_batches as tprefetch
from oim_tpu_torch.data.shuffle import shuffle_batches as tshuffle
from oim_tpu_torch.feeder import driver as tdriver
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

SEQ, BATCH = 16, 2
N_TOKENS = 40 * (SEQ + 1) + 5  # 40 records and a partial one


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    d = tmp_path_factory.mktemp("fed-vol")
    vocab = tllama.tiny().vocab
    data = np.random.default_rng(11).integers(0, vocab, N_TOKENS, dtype=np.int32)
    path = d / "tokens.npy"
    np.save(path, data)
    return data, str(path)


def quick_watch(service):
    """A registry whose Watch streams notice a cancelled client at once
    (the hub sends a keepalive each 20 ms, not each 2 s)."""
    service.watch.keepalive = 0.02
    return service


def settle(service, timeout=5.0):
    """Wait until the registry has ended every Watch stream and recorded
    it: a stream ended after this test would count into the next test's
    metric deltas in this process."""
    deadline = time.monotonic() + timeout
    while service.watch._streams and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)


@contextlib.contextmanager
def remote(controller_mod, backend):
    """JAX's registry with one controller ``host-0`` of the given package."""
    db = MemRegistryDB()
    reg = quick_watch(RegistryService(db=db))
    registry = registry_server("tcp://localhost:0", reg)
    service = controller_mod.ControllerService(backend)
    server = controller_mod.controller_server("tcp://localhost:0", service)
    db.set("host-0/address", server.addr)
    try:
        yield registry.addr, service
    finally:
        server.force_stop()
        settle(reg)
        registry.force_stop()


@contextlib.contextmanager
def both_clusters():
    with remote(jcontroller, JMallocBackend()) as j, \
            remote(tcontroller, CUDABackend(device="cpu")) as t:
        yield j, t


def feed_args(addr, path, **kw):
    base = dict(registry=addr, controller_id="host-0", volume="train", volume_file=path,
                volume_tfrecord="", volume_webdataset="", feed_window_bytes=0,
                publish_timeout=30.0, shuffle=False, shuffle_seed=0, direct_data=True,
                eval_volume_file="", wds_ext="bin")
    base.update(kw)
    return argparse.Namespace(**base)


def cfgs(**kw):
    common = dict(model="llama-tiny", batch_size=BATCH, seq_len=SEQ, lr=1e-2,
                  warmup_steps=2, total_steps=10, log_every=1, seed=3, **kw)
    return jtrainer.TrainConfig(**common), ttrainer.TrainConfig(**common)


def take(it, n):
    return [np.asarray(b["tokens"]) for b in itertools.islice(it, n)]


FEEDS = {
    "whole": dict(feed_window_bytes=0),
    "whole-shuffled": dict(feed_window_bytes=0, shuffle=True, shuffle_seed=5),
    "windowed": dict(feed_window_bytes=1000),
    "windowed-record-multiple": dict(feed_window_bytes=(SEQ + 1) * 4 * 7),
    "windowed-proxy": dict(feed_window_bytes=777, direct_data=False),
}


@pytest.mark.parametrize("name", sorted(FEEDS))
def test_feeder_batches_match_jax(tokens, name):
    _, path = tokens
    jcfg, tcfg = cfgs()
    with both_clusters() as ((jaddr, _), (taddr, _)):
        jf = jdriver.Feeder(registry_address=jaddr, controller_id="host-0")
        tf = tdriver.Feeder(registry_address=taddr, controller_id="host-0")
        try:
            jb = take(jfeeds.feeder_batches(feed_args(jaddr, path, **FEEDS[name]), jcfg,
                                            None, feeder=jf), 70)
            tb = take(tfeeds.feeder_batches(feed_args(taddr, path, **FEEDS[name]), tcfg,
                                            None, feeder=tf), 70)
        finally:
            jf.close()
            tf.close()
    assert len(tb) == len(jb) == 70
    for i, (a, b) in enumerate(zip(tb, jb)):
        assert a.dtype == np.int32 and a.shape == (BATCH, SEQ + 1)
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


@pytest.mark.parametrize("wrap", ["shuffle", "prefetch"])
def test_windowed_reservoir_shuffle_and_prefetch_match_jax(tokens, wrap):
    _, path = tokens
    jcfg, tcfg = cfgs()
    with both_clusters() as ((jaddr, _), (taddr, _)):
        jf = jdriver.Feeder(registry_address=jaddr, controller_id="host-0")
        tf = tdriver.Feeder(registry_address=taddr, controller_id="host-0")
        try:
            jit = jfeeds.feeder_batches(feed_args(jaddr, path, feed_window_bytes=1000), jcfg,
                                        None, feeder=jf)
            tit = tfeeds.feeder_batches(feed_args(taddr, path, feed_window_bytes=1000), tcfg,
                                        None, feeder=tf)
            if wrap == "shuffle":
                jit, tit = jshuffle(jit, 16, seed=3), tshuffle(tit, 16, seed=3)
            else:
                # Finite streams: each producer thread ends with its stream,
                # before the servers stop (a thread left fetching would
                # retry a dead endpoint and count RPCs into later tests).
                jit = jprefetch(itertools.islice(jit, 50), depth=2)
                tit = tprefetch(itertools.islice(tit, 50), depth=2)
            jb, tb = take(jit, 50), take(tit, 50)
        finally:
            jf.close()
            tf.close()
    for a, b in zip(tb, jb, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
def test_seekable_feed_resume_matches_jax(tokens, shuffle):
    _, path = tokens
    jcfg, tcfg = cfgs()
    with both_clusters() as ((jaddr, _), (taddr, _)):
        jf = jdriver.Feeder(registry_address=jaddr, controller_id="host-0")
        tf = tdriver.Feeder(registry_address=taddr, controller_id="host-0")
        try:
            ja = feed_args(jaddr, path, shuffle=shuffle, shuffle_seed=2)
            ta = feed_args(taddr, path, shuffle=shuffle, shuffle_seed=2)
            jfeed = jfeeds.SeekableFeed(
                lambda s: jfeeds.feeder_batches(ja, jcfg, None, s, feeder=jf))
            tfeed = tfeeds.SeekableFeed(
                lambda s: tfeeds.feeder_batches(ta, tcfg, None, s, feeder=tf))
            straight = take(tfeed, 30)
            jfeed.seek(23)
            tfeed.seek(23)
            jb, tb = take(jfeed, 7), take(tfeed, 7)
        finally:
            jf.close()
            tf.close()
    for a, b, c in zip(tb, jb, straight[23:], strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("shuffle", [False, True])
def test_local_mode_whole_volume_feed_matches_jax(tokens, shuffle):
    """A local Feeder's volume is a tensor on the trainer's device: the
    whole-volume feed gathers its records there, in JAX's order."""
    _, path = tokens
    jcfg, tcfg = cfgs()
    args = feed_args("", path, shuffle=shuffle, shuffle_seed=4)
    jf = jdriver.Feeder(controller=jcontroller.ControllerService(JMallocBackend()))
    tf = tdriver.Feeder(controller=tcontroller.ControllerService(CUDABackend(device="cpu")))
    jb = take(jfeeds.feeder_batches(args, jcfg, None, feeder=jf), 45)
    tit = tfeeds.feeder_batches(args, tcfg, None, feeder=tf)
    first = next(tit)
    assert isinstance(first["tokens"], torch.Tensor)
    tb = [first["tokens"].numpy()] + take(tit, 44)
    for a, b in zip(tb, jb, strict=True):
        np.testing.assert_array_equal(a, b)


def test_windowed_batches_over_read_window_give_the_feeders_batches(tokens):
    """The card's path: the windowing loop over ``read_window`` of the
    staged tensor, without a Feeder, cuts the Feeder's batches."""
    data, path = tokens
    _, tcfg = cfgs()
    with remote(tcontroller, CUDABackend(device="cpu")) as (addr, service):
        f = tdriver.Feeder(registry_address=addr, controller_id="host-0")
        try:
            want = take(tfeeds.feeder_batches(feed_args(addr, path, feed_window_bytes=1000),
                                              tcfg, None, feeder=f), 60)
        finally:
            f.close()
        arr = service.get_volume("train").array
        rec = (SEQ + 1) * 4
        got = [raw.view(np.int32).reshape(BATCH, -1) for raw in itertools.islice(
            tfeeds.windowed_batches(lambda o, n: read_window(arr, o, n), 1000, rec,
                                    BATCH * rec), 60)]
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    first = data[:40 * (SEQ + 1)].reshape(40, SEQ + 1)
    np.testing.assert_array_equal(np.concatenate(got[:20]), first)


# --------------------------------------------------------- the trainer ----


def jax_losses(addr, path, window, steps=3):
    """The JAX Trainer's init and losses on JAX's feed of the volume."""
    jcfg, _ = cfgs()
    tr = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    tr.init_or_resume()
    init = jax.tree.map(np.asarray, tr.state.params)
    f = jdriver.Feeder(registry_address=addr, controller_id="host-0")
    try:
        data = jfeeds.feeder_batches(feed_args(addr, path, feed_window_bytes=window), jcfg,
                                     None, feeder=f)
        losses = []
        for _ in range(steps):
            tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
            losses.append(float(stats["loss"]))
    finally:
        f.close()
    return init, losses


def trainer_argv(addr, path, window, *extra):
    return ["--registry", addr, "--controller-id", "host-0", "--volume-file", path,
            "--feed-window-bytes", str(window), "--model", "llama-tiny", "--device", "cpu",
            "--steps", "3", "--batch-size", str(BATCH), "--seq-len", str(SEQ),
            "--lr", "1e-2", "--warmup-steps", "2", "--log-every", "1", "--seed", "3",
            "--log-level", "error", *extra]


@pytest.mark.parametrize("window", [0, 1000], ids=["whole", "windowed"])
def test_trainer_cli_fed_through_the_control_plane_matches_jax(tokens, monkeypatch, window):
    _, path = tokens
    with both_clusters() as ((jaddr, _), (taddr, tservice)):
        init, jlosses = jax_losses(jaddr, path, window)
        trainers = []
        orig = ttrainer.Trainer.init

        def init_from_jax(self, params=None, extra=None):
            trainers.append(self)
            orig(self, tllama.from_numpy(init, device="cpu") if params is None else params,
                 extra)

        monkeypatch.setattr(ttrainer.Trainer, "init", init_from_jax)
        # The windowed run reads synchronously: a prefetch thread would
        # keep fetching windows after the last step, past the servers' stop.
        extra = ["--prefetch-batches", "0"] if window else []
        prev = tlogging.get_global()
        try:
            assert tcli.main(trainer_argv(taddr, path, window, *extra)) == 0
        finally:
            tlogging.set_global(prev)
        assert tservice.get_volume("train-data") is not None  # staged by the port's controller
    (tr,) = trainers
    tlosses = [r["loss"] for r in tr.history if "loss" in r]
    assert len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)


@pytest.mark.parametrize("argv,env,match", [
    (["--volume-tfrecord", "/x.tfrecord"], {}, "llama-family models take --volume-file"),
    ([], {"WORLD_SIZE": "2"}, "--expected-hosts"),
    (["--controller-id", ""], {}, "--controller-id"),
])
def test_refusals_name_the_roadmap_item(tokens, monkeypatch, argv, env, match):
    _, path = tokens
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    prev = tlogging.get_global()
    started = time.monotonic()
    try:
        with pytest.raises(SystemExit, match=match):
            tcli.main(trainer_argv("localhost:1", path, 0, *argv))
    finally:
        tlogging.set_global(prev)
    assert time.monotonic() - started < 30
