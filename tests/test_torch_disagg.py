"""The port's prefill/decode disaggregation and fleet prefix sharing
(``serve/engine.py``'s kv_fetch, snapshot and handoff export,
``serve/kvvolume.py``, ``cli/oim_serve.py``'s ``--role``,
``--kv-peer-fetch`` and ``--kv-export``) held against the JAX package's on
the CPU, at llama.tiny (vocab 64, dim 32, 2 layers, f32), JAX's weights
carried across.

* The handoff (JAX's ``test_handoff_adopt_byte_identity_vs_solo``): a
  ``prefill`` engine chunk-prefills a long prompt and its retirement exports
  the chain; a ``decode`` engine that never held the prefix adopts it, and
  its greedy and sampled streams equal the port's solo ``generate()``.
* Across packages: a chain a JAX prefill engine exports over JAX's
  ``Feeder`` and ``MallocBackend`` is adopted by a port decode engine, and a
  port export by a JAX decode engine; the greedy streams equal solo.
* Each fallback (the callback raising or returning None, a truncated blob, a
  fingerprint with another ``page_tokens``, blocks out of order, blocks the
  pool cannot take) recomputes and records JAX's event fields and counters.
* JAX's ``RouterService`` splits a long prompt across a port ``prefill``
  and a port ``decode`` replica on one control plane; the routed stream
  equals the direct one, and JAX's ``Replica.parse`` reads the port rows'
  role and ``prefix_volumes``. ``oimctl --top``'s ROLE column reads the
  port's ``oim_serve_role``.
* ``oim_serve.main`` with ``--role prefill`` exports through a controller
  that a ``--role decode --kv-peer-fetch`` daemon then adopts from, and
  ``--kv-export`` publishes a mixed replica's hot chain; the checkpoint-dir
  refusals carry JAX's messages.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import types

import grpc
import jax
import numpy as np
import pytest
import torch

from oim_tpu.cli import oim_serve as jcli
from oim_tpu.cli.oimctl import render_top, top_row
from oim_tpu.common import events as jevents
from oim_tpu.common import metrics as jmetrics
from oim_tpu.common import tlsutil as jtlsutil
from oim_tpu.controller import MallocBackend as JMallocBackend
from oim_tpu.controller.controller import ControllerService as JControllerService
from oim_tpu.feeder import Feeder as JFeeder
from oim_tpu.models import generate as jgen
from oim_tpu.models import llama as jllama
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.router import ReplicaTable, RouterService, router_server
from oim_tpu.serve import ServeEngine as JServeEngine
from oim_tpu.serve import kvvolume as jkv
from oim_tpu.spec import RegistryStub, ServeStub, pb
from oim_tpu_torch.cli import oim_serve as tcli
from oim_tpu_torch.common import events as tevents
from oim_tpu_torch.common import prefixhash
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as tmetrics
from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.controller import CUDABackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.controller.controller import ControllerService as TControllerService
from oim_tpu_torch.feeder import Feeder as TFeeder
from oim_tpu_torch.models import generate as tgen
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.serve import ServeEngine as TServeEngine
from oim_tpu_torch.serve import kvvolume as tkv
from oim_tpu_torch.serve import registration as treg
from oim_tpu_torch.serve import service as tservice
from oim_tpu_torch.serve import weights as tweights
from oim_tpu_torch.train import TrainConfig

torch.set_num_threads(2)

BLOCK, MAX_SEQ = 16, 128
PROMPT = np.random.RandomState(5).randint(1, 64, size=49).tolist()  # 3 full blocks + 1


def wait_for(predicate, timeout=30.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, JAX cfg, port cfg): one set of weights."""
    jcfg = jllama.tiny(vocab=64, dim=32, n_layers=2)
    tcfg = tllama.tiny(vocab=64, dim=32, n_layers=2)
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    return jp, tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), jcfg, tcfg


def solo(model, prompt, n, temperature=0.0, seed=0, max_seq=MAX_SEQ):
    """The port's own solo generate() (sampled streams follow torch's
    generator, not JAX's)."""
    _, tp, _, tcfg = model
    out = tgen.generate(tp, torch.tensor([prompt]), n, tcfg, temperature=temperature,
                        rng=torch.Generator().manual_seed(seed), max_seq=max_seq)
    return out[0, len(prompt):].tolist()


def jax_solo(model, prompt, n, max_seq=MAX_SEQ):
    jp, _, jcfg, _ = model
    out = jgen.generate(jp, np.asarray([prompt], np.int32), n, jcfg, max_seq=max_seq)
    return np.asarray(out)[0, len(prompt):].tolist()


ENGINE = dict(max_batch=2, max_seq=MAX_SEQ, queue_depth=8, prefix_block=BLOCK)


def port_engine(model, **kw):
    _, tp, _, tcfg = model
    return TServeEngine(tp, tcfg, device="cpu", **{**ENGINE, **kw})


def jax_engine(model, **kw):
    jp, _, jcfg, _ = model
    return JServeEngine(jp, jcfg, **{**ENGINE, **kw})


def port_feeder():
    return TFeeder(controller=TControllerService(CUDABackend(device="cpu")))


def _value(family, **labels):
    return family.labels(**labels).value if labels else family.value


class Counts:
    """Deltas of a package's fleet-tier counters since construction."""

    NAMES = (("hit", "SERVE_PREFIX_PEER_FETCHES", {"outcome": "hit"}),
             ("miss", "SERVE_PREFIX_PEER_FETCHES", {"outcome": "miss"}),
             ("error", "SERVE_PREFIX_PEER_FETCHES", {"outcome": "error"}),
             ("tokens", "SERVE_PREFIX_PEER_TOKENS", {}),
             ("exports", "KVTIER_EXPORTS", {}),
             ("exported", "SERVE_PREFILL_HANDOFFS", {"outcome": "exported"}),
             ("skipped", "SERVE_PREFILL_HANDOFFS", {"outcome": "skipped"}),
             ("export_failed", "SERVE_PREFILL_HANDOFFS", {"outcome": "export_failed"}))

    def __init__(self, M, events):
        self.M, self.events = M, events
        self.start = self._read()
        seen = events.recorder().events()
        self.seq = seen[-1].seq if seen else -1

    def _read(self):
        return {k: _value(getattr(self.M, fam), **lab) for k, fam, lab in self.NAMES}

    def delta(self):
        return {k: v - self.start[k] for k, v in self._read().items() if v != self.start[k]}

    def new_events(self, type_):
        return [e for e in self.events.recorder().events(type_=type_) if e.seq > self.seq]


def port_counts():
    return Counts(tmetrics, tevents)


def jax_counts():
    return Counts(jmetrics, jevents)


# ------------------------------------------------------------ handoff ----


def test_handoff_adopt_equals_solo(model):
    """The prefill tier chunk-prefills the prompt and its retirement exports
    the chain; a decode engine that never held the prefix adopts it (the
    hit counter moves) and streams the solo tokens, greedy and sampled."""
    feeder = port_feeder()
    prefill = port_engine(model, role="prefill", prefill_chunk=16)
    decode = port_engine(model, role="decode", kv_fetch=tkv.PeerPrefixFetcher(
        feeder, tkv.config_fingerprint(model[3], BLOCK)))
    prefill.set_handoff_export(lambda eng, hashes: tkv.export_chain(eng, feeder, hashes))
    try:
        counts = port_counts()
        prefill.submit(PROMPT, max_new=1).result(timeout=120)
        (volume,) = prefill.exported_volumes().values()
        prefill.submit(PROMPT, max_new=1).result(timeout=120)  # deduped on the deepest hash
        assert counts.delta() == {"exports": 1, "exported": 1, "skipped": 1}
        (ev,) = counts.new_events("kv_chain_exported")
        assert ev.attrs == {"volume": volume, "blocks": 3,
                            "bytes": feeder.controller.get_volume(volume).array.numel()}
        for i, (temp, seed) in enumerate(((0.0, 4), (0.8, 5))):
            decode.evict_prefix_store()  # every trial truly adopts
            toks = decode.submit(PROMPT, max_new=4, temperature=temp,
                                 seed=seed).result(timeout=120)
            assert toks == solo(model, PROMPT, 4, temp, seed), temp
            assert counts.delta()["hit"] == i + 1
        assert counts.delta()["tokens"] == 2 * 3 * BLOCK
        assert [e.attrs for e in counts.new_events("kv_peer_fetch")] == \
            [{"blocks": 3, "tokens": 3 * BLOCK}] * 2
        assert decode.request_stats()["prefill_tokens_cached"] == 2 * 3 * BLOCK
        assert prefill.stats()["prefix_block"] == BLOCK and "prefix_block" not in decode.stats()
    finally:
        for eng in (prefill, decode):
            eng.stop(timeout=30)
        feeder.close()
    for eng in (prefill, decode):
        eng.evict_prefix_store()
        assert eng.pool_stats()["used_pages"] == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cancel_and_short_prompts_export_nothing(model, pkg):
    """Both packages: a prompt under one block is skipped, a cancel exports
    nothing, and a chain gone from the store counts export_failed."""
    build, counts, kv = ((jax_engine, jax_counts, jkv) if pkg == "jax"
                         else (port_engine, port_counts, tkv))
    feeder = (JFeeder(controller=JControllerService(JMallocBackend())) if pkg == "jax"
              else port_feeder())
    prefill = build(model, role="prefill")
    prefill.set_handoff_export(lambda eng, hashes: kv.export_chain(eng, feeder, hashes))
    try:
        c = counts()
        prefill.submit(PROMPT[:10], max_new=1).result(timeout=120)  # under one block
        h = prefill.submit(PROMPT, max_new=60)
        assert wait_for(lambda: h._req.emitted > 0)
        h.cancel()
        h.result(timeout=120)
        assert h.finish_reason == "cancelled"
        assert c.delta() == {"skipped": 1}
        assert prefill.exported_volumes() == {}
        prefill.set_handoff_export(lambda eng, hashes: None)  # the chain evicted
        prefill.submit(PROMPT, max_new=1).result(timeout=120)
        assert c.delta() == {"skipped": 1, "export_failed": 1}
    finally:
        prefill.stop(timeout=30)
        if pkg == "port":
            feeder.close()


def test_hot_chains_and_a_foreign_thread_snapshot(model):
    eng = port_engine(model)
    try:
        assert eng.hot_chains() == [] and eng.snapshot_chain(["x"]) is None
        for prompt in (PROMPT, PROMPT[:33], PROMPT):
            eng.submit(prompt, max_new=1).result(timeout=120)
        chains = eng.hot_chains()
        assert [len(c) for c in chains] == [3, 2] and chains[0][:2] == chains[1]
        assert len(eng.snapshot_chain(chains[0])) == 3  # through the command queue
    finally:
        eng.stop(timeout=30)
    with pytest.raises(Exception, match="draining"):
        eng.snapshot_chain(chains[0])


def test_a_sharded_replica_exports_and_adopts_whole_pages(model):
    """shard 2 (two members on the CPU, each its KV heads of every page):
    its export holds whole pages, the whole engine's manifest and K/V within
    2e-5 (the members' partial sums round in another order), and a sharded
    decode engine adopts a whole engine's chain and streams the solo
    tokens."""
    feeder = port_feeder()
    fp = tkv.config_fingerprint(model[3], BLOCK)
    whole = port_engine(model, role="prefill")
    sharded = port_engine(model, role="prefill", shard=2, devices=["cpu", "cpu"])
    decode = port_engine(model, role="decode", shard=2, devices=["cpu", "cpu"],
                         kv_fetch=tkv.PeerPrefixFetcher(feeder, fp))
    blobs = []
    whole.set_handoff_export(lambda eng, hashes: tkv.export_chain(eng, feeder, hashes))
    sharded.set_handoff_export(lambda eng, hashes: tkv.export_chain_to(
        eng, hashes, lambda vid, path, n: blobs.append(open(path, "rb").read()) or n))
    try:
        for eng in (whole, sharded):
            eng.submit(PROMPT, max_new=1).result(timeout=120)
        (volume,) = whole.exported_volumes().values()
        staged = feeder.controller.get_volume(volume).array.numpy()
        want_hashes, want, _ = tkv.unpack_chain(staged, fp)
        (blob,) = blobs
        assert len(blob) == len(staged) and blob[:16] == staged[:16].tobytes()
        got_hashes, got, _ = tkv.unpack_chain(blob, fp)
        assert got_hashes == want_hashes
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, atol=2e-5, rtol=0)
        counts = port_counts()
        toks = decode.submit(PROMPT, max_new=6).result(timeout=120)
    finally:
        for eng in (whole, sharded, decode):
            eng.stop(timeout=30)
        feeder.close()
    assert toks == solo(model, PROMPT, 6)
    assert counts.delta() == {"hit": 1, "tokens": 3 * BLOCK}


# ------------------------------------------------------ across packages ----


def test_a_jax_export_is_adopted_by_a_port_decode_engine(model):
    jfeeder = JFeeder(controller=JControllerService(JMallocBackend()))
    prefill = jax_engine(model, role="prefill", prefill_chunk=16)
    prefill.set_handoff_export(lambda eng, hashes: jkv.export_chain(eng, jfeeder, hashes))
    decode = port_engine(model, role="decode", kv_fetch=tkv.PeerPrefixFetcher(
        jfeeder, tkv.config_fingerprint(model[3], BLOCK)))
    try:
        prefill.submit(PROMPT, max_new=1).result(timeout=120)
        assert prefill.exported_volumes()
        counts = port_counts()
        toks = decode.submit(PROMPT, max_new=6).result(timeout=120)
    finally:
        prefill.stop(timeout=30)
        decode.stop(timeout=30)
    assert toks == solo(model, PROMPT, 6) == jax_solo(model, PROMPT, 6)
    assert counts.delta() == {"hit": 1, "tokens": 3 * BLOCK}


def test_a_port_export_is_adopted_by_a_jax_decode_engine(model):
    jfeeder = JFeeder(controller=JControllerService(JMallocBackend()))

    def publish(volume_id, path, total_bytes):
        return jfeeder.publish(jkv.chain_request(volume_id, path, total_bytes)).bytes

    prefill = port_engine(model, role="prefill", prefill_chunk=16)
    prefill.set_handoff_export(lambda eng, hashes: tkv.export_chain_to(
        eng, hashes, publish))
    decode = jax_engine(model, role="decode", kv_fetch=jkv.PeerPrefixFetcher(
        jfeeder, jkv.config_fingerprint(model[2], BLOCK)))
    try:
        prefill.submit(PROMPT, max_new=1).result(timeout=120)
        (volume,) = prefill.exported_volumes().values()
        counts = jax_counts()
        toks = decode.submit(PROMPT, max_new=6).result(timeout=120)
    finally:
        prefill.stop(timeout=30)
        decode.stop(timeout=30)
    assert toks == jax_solo(model, PROMPT, 6)
    assert counts.delta() == {"hit": 1, "tokens": 3 * BLOCK}
    assert jfeeder.controller.get_volume(volume) is not None


# ------------------------------------------------------------ fallbacks ----


def _blob(kv, model, fp=None, shape=None):
    """A packed chain of PROMPT's 3 usable blocks, random bits of the tiny
    pool's page shape (or ``shape``), under the engine's fingerprint."""
    cfg = model[3]
    page = shape or (cfg.n_layers, BLOCK, cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.RandomState(9)
    hashes = prefixhash.usable_hashes(PROMPT, BLOCK)
    blocks = [(rng.rand(*page).astype(np.float32), rng.rand(*page).astype(np.float32))
              for _ in hashes]
    fp = fp or tkv.config_fingerprint(cfg, BLOCK)
    return hashes, np.frombuffer(kv.pack_chain(hashes, blocks, BLOCK, fp), np.uint8)


def _fetcher(kv, blob_of):
    """The package's own PeerPrefixFetcher over a controller holding one
    volume (``blob_of`` -> (hashes, bytes))."""
    hashes, raw = blob_of
    volumes = {kv.chain_volume_id(hashes): types.SimpleNamespace(array=raw)}
    feeder = types.SimpleNamespace(controller=types.SimpleNamespace(get_volume=volumes.get))
    return lambda model: kv.PeerPrefixFetcher(feeder, kv.config_fingerprint(model, BLOCK))


def _raising(cfg):
    def fetch(chain, m):
        raise RuntimeError("peer died mid-stream")
    return fetch


FALLBACKS = {
    # name: (fetcher factory from (kv module, model fixture), fetch counter)
    "raises": lambda kv, model: _raising,
    "none": lambda kv, model: (lambda cfg: lambda chain, m: None),
    "truncated": lambda kv, model: _fetcher(kv, (lambda h, r: (h, r[:-8]))(
        *_blob(kv, model))),
    "other page_tokens": lambda kv, model: _fetcher(kv, _blob(
        kv, model, fp=dict(tkv.config_fingerprint(model[3], BLOCK), page_tokens=32))),
    "out of order": lambda kv, model: (lambda cfg: lambda chain, m: [
        ("not-" + chain[m], (np.zeros(1), np.zeros(1)))]),
    "pool cannot take": lambda kv, model: _fetcher(kv, _blob(
        kv, model, shape=(model[3].n_layers, BLOCK // 2, model[3].n_kv_heads,
                          model[3].head_dim))),
}


@pytest.mark.parametrize("case", FALLBACKS)
def test_each_fallback_recomputes_with_jax_fields(model, case):
    runs = {}
    for name, kv, build, counts, cfg in (
            ("jax", jkv, jax_engine, jax_counts, model[2]),
            ("port", tkv, port_engine, port_counts, model[3])):
        eng = build(model, role="decode", kv_fetch=FALLBACKS[case](kv, model)(cfg))
        c = counts()
        try:
            h = eng.submit(PROMPT, max_new=5)
            toks = h.result(timeout=120)
            stats = h.stats["prefix_tokens"]
        finally:
            eng.stop(timeout=30)
        eng.evict_prefix_store()
        assert eng.pool_stats()["used_pages"] == 0, name
        runs[name] = (toks, stats, c.delta(),
                      [dict(e.attrs) for e in c.new_events("kv_fetch_fallback")],
                      c.new_events("kv_peer_fetch"))
    (jtoks, jstats, jdelta, jev, jpeer), (ttoks, tstats, tdelta, tev, tpeer) = \
        runs["jax"], runs["port"]
    assert ttoks == jtoks == jax_solo(model, PROMPT, 5)
    assert tstats == jstats == 0 and tpeer == jpeer == []
    assert tdelta == jdelta
    assert len(tev) == len(jev) == (0 if case == "out of order" else 1)
    for t, j in zip(tev, jev):
        assert t.keys() == j.keys()
        assert {k: v for k, v in t.items() if k != "error"} == \
            {k: v for k, v in j.items() if k != "error"} == \
            {"matched_blocks": 0, "chain_blocks": 3}
        if case == "raises":
            assert t["error"] == j["error"] == repr(RuntimeError("peer died mid-stream"))


# ------------------------------------------------ router and oimctl ----


class Replica:
    """A port engine behind the port's serve_server on port 0, registered
    as ``serve/<sid>`` in the registry at ``registry``."""

    def __init__(self, sid, eng, registry):
        self.eng = eng
        self.server = tservice.serve_server("tcp://127.0.0.1:0", tservice.ServeService(eng))
        self.reg = treg.ServeRegistration(sid, self.server.addr, eng, registry, interval=0.1)
        self.reg.start()

    def close(self):
        self.reg.stop(deregister=True)
        self.server.stop()
        self.eng.stop(drain=False, timeout=30)


def _registry():
    service = RegistryService(db=MemRegistryDB())
    service.watch.keepalive = 0.02
    return service, registry_server("tcp://localhost:0", service)


def test_jax_router_splits_across_port_prefill_and_decode(model):
    service, registry = _registry()
    feeder = port_feeder()
    fp = tkv.config_fingerprint(model[3], BLOCK)
    prefill = Replica("p0", port_engine(model, role="prefill", prefill_chunk=16),
                      registry.addr)
    prefill.eng.set_handoff_export(lambda eng, hashes: tkv.export_chain(eng, feeder, hashes))
    decode = Replica("d0", port_engine(model, role="decode",
                                       kv_fetch=tkv.PeerPrefixFetcher(feeder, fp)),
                     registry.addr)
    table = ReplicaTable(registry.addr, interval=0.1)
    table.start()
    router = router_server("tcp://127.0.0.1:0", RouterService(table))
    channel = jtlsutil.dial(router.addr, None)
    try:
        assert wait_for(lambda: len(table) == 2)
        split = jmetrics.SERVE_PREFILL_HANDOFFS.labels(outcome="split").value
        counts = port_counts()
        deltas = list(ServeStub(channel).Generate(
            pb.GenerateRequest(prompt=PROMPT, max_new_tokens=6), timeout=120))
        routed = [t for d in deltas for t in d.tokens]
        assert deltas[-1].finish_reason == "length"
        assert jmetrics.SERVE_PREFILL_HANDOFFS.labels(outcome="split").value == split + 1
        assert counts.delta() == {"hit": 1, "tokens": 3 * BLOCK, "exports": 1, "exported": 1}
        assert routed == solo(model, PROMPT, 6)
        decode.eng.evict_prefix_store()
        with jtlsutil.dial(decode.server.addr, None) as direct_channel:
            direct = [t for d in ServeStub(direct_channel).Generate(
                pb.GenerateRequest(prompt=PROMPT, max_new_tokens=6), timeout=120)
                for t in d.tokens]
        assert direct == routed
        (volume,) = prefill.eng.exported_volumes().items()

        def parsed():
            return {r.replica_id: r for r in table.replicas()}

        assert wait_for(lambda: parsed()["p0"].prefix_volumes == {volume[0]})
        rows = parsed()
        assert (rows["p0"].role, rows["d0"].role) == ("prefill", "decode")
        assert rows["p0"].prefix_block == BLOCK
    finally:
        channel.close()
        router.stop()
        table.stop()
        for rep in (prefill, decode):
            rep.close()
        feeder.close()
        wait_for(lambda: not service.watch._streams, 5)
        registry.stop()


@pytest.mark.parametrize("role", ["prefill", "decode", "mixed"])
def test_top_role_column_reads_the_ports_role(role):
    reg = tmetrics.Registry()
    reg.gauge(tmetrics.SERVE_ROLE.name, tmetrics.SERVE_ROLE.help,
              labelnames=("role",)).labels(role=role).set(1)
    text = reg.render()
    events_page = json.dumps({"events": [], "dropped": 0})
    row = top_row("r0", "ALIVE", "serve", "127.0.0.1:1",
                  http_get=lambda url, timeout=10.0: events_page if "/debug/events" in url
                  else text)
    assert row["tier"] == role
    assert role in render_top([row])


# ----------------------------------------------------------------- CLI ----


class Daemon:
    """``oim_serve.main(argv)`` in this (the main) thread, with a client thread
    that waits for its socket, runs ``check`` and then sends the process
    SIGTERM; the previous SIGTERM handler comes back after."""

    def __init__(self, sock, check):
        self.sock, self.check, self.out, self.error = sock, check, {}, None
        self.prev = signal.getsignal(signal.SIGTERM)
        self.done = threading.Event()

    def _client(self):
        try:
            assert wait_for(lambda: os.path.exists(self.sock) or self.done.is_set(), 60)
            if self.done.is_set():
                return
            with grpc.insecure_channel(f"unix://{self.sock}") as ch:
                grpc.channel_ready_future(ch).result(timeout=60)
                self.check(ServeStub(ch), self.out)
        except BaseException as e:  # noqa: BLE001 - reported by run()
            self.error = e
        finally:
            installed = wait_for(lambda: self.done.is_set()
                                 or signal.getsignal(signal.SIGTERM) is not self.prev, 30)
            if installed and not self.done.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    def run(self, argv):
        thread = threading.Thread(target=self._client, daemon=True)
        thread.start()
        try:
            rc = tcli.main(argv + ["--endpoint", f"unix://{self.sock}", "--device", "cpu",
                                   "--log-level", "error", "--max-batch", "2",
                                   "--max-seq", str(MAX_SEQ), "--prefix-block", str(BLOCK)])
        finally:
            self.done.set()
            signal.signal(signal.SIGTERM, self.prev)
            tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
        thread.join(30)
        if self.error is not None:
            raise self.error
        return rc


def _stream(n):
    def check(stub, out):
        deltas = list(stub.Generate(pb.GenerateRequest(prompt=PROMPT, max_new_tokens=n),
                                    timeout=60))
        out["tokens"] = [t for d in deltas for t in d.tokens]
    return check


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """The daemon's llama-tiny weights, packed to a file."""
    tcfg = TrainConfig(model="llama-tiny").model_config()
    jp = jllama.init(jax.random.PRNGKey(0), jllama.tiny())
    tp = tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    path = str(tmp_path_factory.mktemp("disagg-cli") / "w.oimw")
    tweights.save_packed(tp, path)
    return path, (None, tp, None, tcfg)


def test_main_prefill_exports_and_a_decode_daemon_adopts(cli_model, tmp_path):
    """Remote mode, one controller: --role prefill's retirement publishes the
    chain to it, and a --role decode --kv-peer-fetch daemon booted after
    reads it back over the window path and adopts it."""
    path, tmodel = cli_model
    service, registry = _registry()
    ctl = tcontroller.Controller(
        controller_id="host-0", backend=CUDABackend(device="cpu"),
        controller_address="pending", registry_address=registry.addr,
        registry_delay=0.1, mesh_coord=MeshCoord.parse("1,2,3"))
    server = tcontroller.controller_server("tcp://localhost:0", ctl.service)
    ctl.controller_address = server.addr
    ctl.start()
    channel = jtlsutil.dial(registry.addr, None)
    stub = RegistryStub(channel)
    try:
        assert wait_for(lambda: any(v.path.endswith("/address") for v in stub.GetValues(
            pb.GetValuesRequest(path=""), timeout=10).values))
        remote = ["--registry", registry.addr, "--controller-id", "host-0"]
        counts = port_counts()
        first = Daemon(str(tmp_path / "p.sock"), _stream(1))
        assert first.run(["--weights-file", path, "--role", "prefill"] + remote) == 0
        assert counts.delta() == {"exports": 1, "exported": 1}
        volume = tkv.chain_volume_id(prefixhash.usable_hashes(PROMPT, BLOCK))
        assert ctl.service.get_volume(volume) is not None
        second = Daemon(str(tmp_path / "d.sock"), _stream(6))
        assert second.run(["--restore-only", "--role", "decode", "--kv-peer-fetch"]
                          + remote) == 0
        assert second.out["tokens"] == solo(tmodel, PROMPT, 6)
        assert counts.delta() == {"exports": 1, "exported": 1, "hit": 1,
                                  "tokens": 3 * BLOCK}
    finally:
        channel.close()
        ctl.stop()
        server.stop()
        wait_for(lambda: not service.watch._streams, 5)
        registry.stop()


def test_main_kv_export_publishes_a_hot_chain(cli_model, tmp_path):
    path, tmodel = cli_model
    counts = port_counts()

    def check(stub, out):
        _stream(3)(stub, out)
        out["exported"] = wait_for(lambda: counts.delta().get("exports") == 1, 30)

    d = Daemon(str(tmp_path / "s.sock"), check)
    assert d.run(["--weights-file", path, "--backend", "cuda", "--kv-export",
                  "--heartbeat", "0.1"]) == 0
    assert d.out == {"tokens": solo(tmodel, PROMPT, 3), "exported": True}


@pytest.mark.parametrize("argv", [
    ["--checkpoint-dir", "c", "--kv-export"],
    ["--checkpoint-dir", "c", "--kv-peer-fetch", "--kv-export", "--role", "decode"],
    ["--checkpoint-dir", "c", "--role", "prefill", "--kv-export"],
])
def test_checkpoint_dir_refusals_carry_the_jax_messages(argv):
    msgs = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as err:
            main(argv + ["--log-level", "error"])
        msgs.append(str(err.value))
    tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    assert msgs[1] == msgs[0] and "control plane" in msgs[0]


@pytest.mark.parametrize("argv", [["--role", "prefill"], ["--role", "decode"],
                                  ["--kv-peer-fetch"], ["--kv-export"]])
def test_fleet_flags_parse_and_pass_the_checks(argv):
    args = tcli.parse_args(["--restore-only", "--backend", "malloc"] + argv)
    tcli.check_args(args)
    assert args.role == (argv[1] if argv[0] == "--role" else "mixed")
