"""The port's observability sites held against the JAX package's: the same
workload through both packages records the same metric deltas, label
values, event types (in order), span names and fault-point outcomes.

* ``ServeEngine`` on llama.tiny (vocab 64, dim 32, 2 layers; one set of
  weights carried across): seeded greedy requests, a shared prefix, a
  host-tier round trip, a cancel, a drain and a self-draft speculator;
  then each of the four fault points armed in both engines.
* ``MallocBackend`` and ``CUDABackend(device="cpu")`` against JAX's
  ``MallocBackend`` and ``TPUBackend``: one volume staged twice and evicted.
* ``read_into``, ``stream``, ``read_object`` and ``read_range`` against a
  local file and an in-test HTTP server.
* The trainer's gauges and ``train.step`` spans on llama-tiny and
  llama-tiny-moe, and JAX's autopsy and the port's (``obs/autopsy.py``)
  reading a request from either package's ``/debug`` endpoints.
* Drift and list checks: every family the port declares is recorded by a
  module of the port, and every family, event type, span name and fault
  point the JAX package records at the ported sites (the control plane's
  among them: the controller, the feeder driver, the channel pool, the
  RPC interceptors, the registry and the router) is the port's, except
  the deferred ones, named below.
  The control plane's sites are driven in ``test_torch_feeder.py`` and
  ``test_torch_controller_service.py``.

Metrics, rings and span recorders are process-global in each package, so
every comparison is a delta read before and after a workload.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import http.server
import re
import threading
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oim_tpu.common import events as jevents
from oim_tpu.common import faultinject as jfault
from oim_tpu.common import metrics as jmetrics
from oim_tpu.common import tracing as jtracing
from oim_tpu.controller.backend import StagedVolume as JStagedVolume
from oim_tpu.controller.malloc_backend import MallocBackend as JMallocBackend
from oim_tpu.controller.tpu_backend import TPUBackend
from oim_tpu.data import objectstore as jobjectstore
from oim_tpu.data import staging as jstaging
from oim_tpu.models import llama as jllama
from oim_tpu.obs import autopsy
from oim_tpu.serve import engine as jengine
from oim_tpu.spec import pb
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch import spec as tspec
from oim_tpu_torch.common import events as tevents
from oim_tpu_torch.common import faultinject as tfault
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as tmetrics
from oim_tpu_torch.common import tracing as ttracing
from oim_tpu_torch.controller import CUDABackend, MallocBackend, StagedVolume
from oim_tpu_torch.data import objectstore as tobjectstore
from oim_tpu_torch.data import staging as tstaging
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.obs import autopsy as tautopsy
from oim_tpu_torch.serve import engine as tengine
from oim_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parent.parent

JAX = types.SimpleNamespace(name="jax", M=jmetrics, events=jevents, fault=jfault,
                            tracing=jtracing, engine=jengine, kw={})
PORT = types.SimpleNamespace(name="port", M=tmetrics, events=tevents, fault=tfault,
                             tracing=ttracing, engine=tengine, kw={"device": "cpu"})
PKGS = (JAX, PORT)

PORT_FAMILIES = set(tmetrics.DEFAULT._metrics)
# The control plane's families (RPCs, the feeder's windows, channel pools,
# heartbeats) are compared in test_torch_feeder.py; the registry's, the
# router's, the SLO plane's and the autoscaler's in test_torch_registry.py,
# test_torch_chaos.py, test_torch_fleet_slo.py and test_torch_autoscale.py.
# This file's workloads make no RPC, and a stream another test file left in
# this process may still end (or resync, and count) during one of them, so
# its reads leave them out.
CONTROL_PLANE_FAMILIES = {
    "oim_rpc_latency_seconds", "oim_rpc_total", "oim_window_path_total",
    "oim_window_gbps", "oim_channel_pool_size", "oim_heartbeat_rtt_seconds",
    "oim_feeder_failovers_total", "oim_stage_wait_seconds"} | {
    n for n in PORT_FAMILIES if n.startswith((
        "oim_registry_", "oim_replication_", "oim_watch_", "oim_lease_", "oim_proxy_",
        "oim_router_", "oim_slo_", "oim_autoscale_", "oim_top_merge_"))}

# Sites of the ported modules whose code the port does not have yet, each
# with the queue item (ROADMAP.md) that brings it.
DEFERRED_FAMILIES: dict[str, str] = {}
DEFERRED_EVENTS: dict[str, str] = {}
# JAX modules whose sites this slice ports, and their counterparts.
PORTED_SITES = {
    "oim_tpu/serve/engine.py": "oim_tpu_torch/serve/engine.py",
    "oim_tpu/serve/pagepool.py": "oim_tpu_torch/serve/pagepool.py",
    "oim_tpu/serve/prefixcache.py": "oim_tpu_torch/serve/prefixcache.py",
    "oim_tpu/serve/kvtier.py": "oim_tpu_torch/serve/kvtier.py",
    "oim_tpu/serve/kvvolume.py": "oim_tpu_torch/serve/kvvolume.py",
    "oim_tpu/controller/stagecache.py": "oim_tpu_torch/controller/stagecache.py",
    "oim_tpu/controller/malloc_backend.py": "oim_tpu_torch/controller/malloc_backend.py",
    "oim_tpu/controller/tpu_backend.py": "oim_tpu_torch/controller/cuda_backend.py",
    "oim_tpu/data/staging.py": "oim_tpu_torch/data/staging.py",
    "oim_tpu/data/objectstore.py": "oim_tpu_torch/data/objectstore.py",
    "oim_tpu/train/trainer.py": "oim_tpu_torch/train/trainer.py",
    "oim_tpu/common/events.py": "oim_tpu_torch/common/events.py",
    "oim_tpu/controller/controller.py": "oim_tpu_torch/controller/controller.py",
    "oim_tpu/feeder/driver.py": "oim_tpu_torch/feeder/driver.py",
    "oim_tpu/common/channelpool.py": "oim_tpu_torch/common/channelpool.py",
    "oim_tpu/common/tracing.py": "oim_tpu_torch/common/rpctelemetry.py",
    "oim_tpu/serve/service.py": "oim_tpu_torch/serve/service.py",
    "oim_tpu/common/telemetry.py": "oim_tpu_torch/common/telemetry.py",
    "oim_tpu/registry/leases.py": "oim_tpu_torch/registry/leases.py",
    "oim_tpu/registry/registry.py": "oim_tpu_torch/registry/registry.py",
    "oim_tpu/registry/replication.py": "oim_tpu_torch/registry/replication.py",
    "oim_tpu/registry/quorum.py": "oim_tpu_torch/registry/quorum.py",
    "oim_tpu/registry/watch.py": "oim_tpu_torch/registry/watch.py",
    "oim_tpu/router/table.py": "oim_tpu_torch/router/table.py",
    "oim_tpu/router/router.py": "oim_tpu_torch/router/router.py",
    "oim_tpu/obs/merge.py": "oim_tpu_torch/obs/merge.py",
    "oim_tpu/obs/slo.py": "oim_tpu_torch/obs/slo.py",
    "oim_tpu/autoscale/daemon.py": "oim_tpu_torch/autoscale/daemon.py",
}


@pytest.fixture(autouse=True, scope="module")
def jax_staging_built():
    """The JAX package's libstaging.so built (``staging.build()``, as
    tests/test_staging.py's fixture builds it) before this file's first
    ``jstaging`` read: a read made while the library is missing caches the
    miss for the life of the process, and test_staging.py run later in the
    same process would then skip all its native tests."""
    jstaging.build()


@pytest.fixture(autouse=True, scope="module")
def fresh_rings():
    """One span recorder and one event ring per package for this file's
    process (big enough that nothing wraps), restored after."""
    prev = [(p.tracing.recorder(), p.events.recorder()) for p in PKGS]
    for p in PKGS:
        p.tracing.configure(f"{p.name}-sites", capacity=1 << 16)
        p.events.configure(capacity=1 << 16)
    log = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(log)
    for p, (spans, evs) in zip(PKGS, prev):
        p.tracing._recorder, p.events._recorder = spans, evs
        p.fault.reset()


# ----------------------------------------------------------------- reads ----


def snap(M) -> dict:
    """(family, labels) -> value for every child of every family of the
    port's slice but the control plane's; a histogram child reads its
    observation count."""
    out = {}
    for name in PORT_FAMILIES - CONTROL_PLANE_FAMILIES:
        fam = M.DEFAULT._metrics[name]
        with fam._family_lock:
            children = list(fam._children.items())
        for key, child in children:
            out[(name, key)] = child.count if isinstance(fam, M.Histogram) else child.value
    return out


class Reads:
    """Before/after reads of one package's registry, ring and spans."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.before = snap(pkg.M)
        self.seq = max((e.seq for e in pkg.events.recorder().events()), default=0)
        self.n_spans = len(pkg.tracing.recorder().spans())

    def deltas(self) -> dict:
        """Counter and histogram-count deltas (nonzero only)."""
        after = snap(self.pkg.M)
        out = {}
        for key, val in after.items():
            if isinstance(self.pkg.M.DEFAULT._metrics[key[0]], self.pkg.M.Gauge):
                continue
            d = val - self.before.get(key, 0)
            if d:
                out[key] = d
        return out

    def gauge(self, name, *labels):
        fam = getattr(self.pkg.M, name)
        return fam.labels(*labels).value if labels else fam.value

    def events(self):
        return [e for e in self.pkg.events.recorder().events() if e.seq > self.seq]

    def spans(self):
        """The spans of the sites' names recorded since the snapshot: a
        span another thread leaves in the ring meanwhile (an earlier test
        file's server on the same worker) is not this workload's."""
        return [s for s in self.pkg.tracing.recorder().spans()[self.n_spans:]
                if s.name in SITE_SPANS]


# The span names the port's sites record (stage, train and serving).
SITE_SPANS = frozenset({"stage", "train.step", "serve.prefill", "serve.draft_prefill",
                        "serve.queue_wait", "serve.decode"})

# Counters of seconds: equal in presence, not in value.
TIMED = {"oim_stage_seconds_total"}


def _same(reads_j: Reads, reads_t: Reads):
    def counts(reads):
        return {k: (v > 0 if k[0] in TIMED else v) for k, v in reads.deltas().items()}

    assert counts(reads_t) == counts(reads_j)
    assert [(e.type, sorted(e.attrs)) for e in reads_t.events()] == \
        [(e.type, sorted(e.attrs)) for e in reads_j.events()]
    assert collections.Counter(s.name for s in reads_t.spans()) == \
        collections.Counter(s.name for s in reads_j.spans())


# ---------------------------------------------------------------- serving ----


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny(vocab=64, dim=32, n_layers=2)
    tcfg = tllama.tiny(vocab=64, dim=32, n_layers=2)
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    tp = tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": (jp, jcfg), "port": (tp, tcfg)}


GEOMETRY = dict(max_batch=2, max_seq=64, queue_depth=8, prefix_block=8)
_rs = np.random.RandomState(11)
PREFIX = _rs.randint(0, 64, 16).tolist()
PROMPT_A = PREFIX + _rs.randint(0, 64, 4).tolist()
PROMPT_B = PREFIX + _rs.randint(0, 64, 5).tolist()
PROMPT_CANCEL = _rs.randint(0, 64, 12).tolist()
CANCEL_AT = 3


def _engine(pkg, model, **kw):
    params, cfg = model[pkg.name]
    return pkg.engine.ServeEngine(params, cfg, name="sites", **{**GEOMETRY, **kw}, **pkg.kw)


def _cancel_at(eng, prompt, n):
    """Cancel the request with ``prompt`` right after its n-th token, in
    the engine's own thread: the retirement check that follows the
    emission sees it, so the cancel lands at a fixed token in both
    engines."""
    orig = eng._emit

    def emit(req, token):
        orig(req, token)
        if req.prompt == prompt and req.emitted == n:
            req.cancelled.set()

    eng._emit = emit


def _serve_workload(pkg, model):
    eng = _engine(pkg, model, kv_host_bytes=1 << 20)
    _cancel_at(eng, PROMPT_CANCEL, CANCEL_AT)
    out = {}
    for name, prompt, n in (("a", PROMPT_A, 6), ("b", PROMPT_B, 6)):
        h = eng.submit(prompt, max_new=n)
        out[name] = (h.result(timeout=60), h.finish_reason)
    out["demoted"] = eng.evict_prefix_store()
    h = eng.submit(PROMPT_A, max_new=6)  # promoted back from the host tier
    out["a again"] = (h.result(timeout=60), h.finish_reason, h.stats["prefix_tokens"])
    h = eng.submit(PROMPT_CANCEL, max_new=10)
    out["cancel"] = (h.result(timeout=60), h.finish_reason)
    out["host"] = eng.host_stats()
    eng.stop(drain=True)
    eng.evict_prefix_store()
    eng.evict_host_tier()
    out["pool"] = eng.pool_stats()["used_pages"]
    return out


def test_serving_workload_records_equal_deltas(model):
    runs = {}
    for pkg in PKGS:
        reads = Reads(pkg)
        out = _serve_workload(pkg, model)
        runs[pkg.name] = (reads, out, {
            g: reads.gauge(g) for g in ("SERVE_KV_PAGES_TOTAL", "SERVE_KV_PAGES_USED",
                                        "SERVE_KV_PAGES_SHARED", "KVTIER_HOST_PAGES",
                                        "KVTIER_HOST_BYTES", "KVTIER_HBM_PAGES",
                                        "SERVE_PREFIX_CACHE_BYTES", "SERVE_QUEUE_DEPTH",
                                        "SERVE_SLOT_OCCUPANCY")})
    (jr, jout, jg), (tr, tout, tg) = runs["jax"], runs["port"]
    assert tout == jout
    assert tg == jg
    _same(jr, tr)
    d = tr.deltas()
    n_tokens = sum(len(v[0]) for k, v in tout.items() if k in ("a", "b", "a again", "cancel"))
    assert d[("oim_serve_tokens_total", ())] == n_tokens == 6 + 6 + 6 + CANCEL_AT
    assert d[("oim_serve_requests_total", ("length",))] == 3
    assert d[("oim_serve_requests_total", ("cancelled",))] == 1
    assert d[("oim_serve_token_latency_seconds", ("first",))] == 4
    assert d[("oim_serve_first_token_seconds", ("hit",))] == 2
    assert d[("oim_serve_prefix_hits_total", ())] == 2
    assert d[("oim_serve_prefill_tokens_total", ("cache",))] == 2 * 16
    assert tout["host"]["demotions"] == tout["host"]["promotions"] == 2
    # Two blocks demoted, promoted back, and demoted again with the
    # cancelled prompt's one block at the final eviction.
    assert d[("oim_kvtier_demotions_total", ())] == 2 + 2 + 1
    assert d[("oim_kvtier_promotions_total", ())] == 2
    assert [e.type for e in tr.events()] == ["slot_evicted", "replica_drain"]
    assert tr.events()[0].attrs == {"slot": 0, "reason": "cancelled", "tokens": CANCEL_AT}
    names = collections.Counter(s.name for s in tr.spans())
    assert names == {"serve.prefill": 4, "serve.queue_wait": 4, "serve.decode": 4}
    assert tg["SERVE_KV_PAGES_USED"] == 0 and tout["pool"] == 0
    assert tr.gauge("SERVE_ROLE", "mixed") == 1.0


def test_speculation_records_equal_deltas(model):
    runs = {}
    for pkg in PKGS:
        params, cfg = model[pkg.name]
        reads = Reads(pkg)
        eng = _engine(pkg, model, draft_params=params, draft_cfg=cfg, spec_tokens=2)
        out = [eng.submit(p, max_new=9).result(timeout=60) for p in (PROMPT_A, PROMPT_CANCEL)]
        eng.stop(quiet=True)
        runs[pkg.name] = (reads, out, reads.gauge("SERVE_SPEC_ACCEPT_ROLLING"),
                          eng.stats()["spec_proposed"])
    (jr, jout, jroll, jprop), (tr, tout, troll, tprop) = runs["jax"], runs["port"]
    assert tout == jout and troll == jroll and tprop == jprop > 0
    _same(jr, tr)
    d = tr.deltas()
    assert d[("oim_serve_spec_proposed_tokens_total", ())] == tprop
    assert d[("oim_serve_spec_accepted_tokens_total", ())] > 0
    assert collections.Counter(s.name for s in tr.spans())["serve.draft_prefill"] == 2


def test_spec_fallback_event_and_counter(model):
    """A draft that never agrees trips the valve: one spec_fallback event
    and counter in each package."""
    runs = {}
    for pkg in PKGS:
        params, cfg = model[pkg.name]
        if pkg is JAX:
            draft = jax.tree.map(lambda x: -x, params)
        else:
            draft = jax.tree.map(lambda x: -x, params, is_leaf=torch.is_tensor)
        reads = Reads(pkg)
        eng = _engine(pkg, model, draft_params=draft, draft_cfg=cfg, spec_tokens=2,
                      spec_accept_floor=0.99, spec_window_rounds=2)
        out = eng.submit(PROMPT_A, max_new=12).result(timeout=60)
        eng.stop(quiet=True)
        runs[pkg.name] = (reads, out)
    (jr, jout), (tr, tout) = runs["jax"], runs["port"]
    assert tout == jout
    _same(jr, tr)
    assert tr.deltas()[("oim_serve_spec_fallback_total", ())] == 1
    fb = [e for e in tr.events() if e.type == "spec_fallback"]
    assert len(fb) == 1 and fb[0].attrs["accept_floor"] == 0.99


def _fault_case(pkg, model, point):
    """Arm ``point`` in pkg's engine; returns what a caller observes."""
    params, cfg = model[pkg.name]
    pkg.fault.reset()
    kw = {"draft_params": params, "draft_cfg": cfg, "spec_tokens": 2} \
        if point == "spec.propose" else {}
    eng = _engine(pkg, model, **kw)
    seen = {}
    if point == "serve.admit":
        pkg.fault.arm(point, exc=pkg.engine.QueueFull("injected"), times=1, engine="sites")
        with pytest.raises(pkg.engine.QueueFull):
            eng.submit(PROMPT_A, max_new=4)
    else:
        pkg.fault.arm(point, times=1, engine="sites")
    h = eng.submit(PROMPT_A, max_new=4)
    seen["tokens"], seen["reason"] = h.result(timeout=60), h.finish_reason
    seen["fired"] = pkg.fault.fired(point)
    seen["proposed"] = eng.stats().get("spec_proposed")
    try:
        eng.submit(PROMPT_B, max_new=2).result(timeout=60)
        seen["after"] = "admitted"
    except pkg.engine.Draining:
        seen["after"] = "draining"
    eng.stop(quiet=True)
    eng.evict_prefix_store()
    seen["used_pages"] = eng.pool_stats()["used_pages"]
    pkg.fault.reset()
    return seen


@pytest.mark.parametrize("point,want", [
    ("serve.admit", {"reason": "length", "after": "admitted", "tokens": 4}),
    ("spec.propose", {"reason": "length", "after": "admitted", "tokens": 4}),
    ("serve.retire", {"reason": "error", "after": "draining", "tokens": 4}),
    ("serve.decode", {"reason": "error", "after": "draining", "tokens": 1}),
])
def test_fault_point_outcomes_match_jax(model, point, want):
    runs = {}
    for pkg in PKGS:
        reads = Reads(pkg)
        runs[pkg.name] = (reads, _fault_case(pkg, model, point))
    (jr, jseen), (tr, tseen) = runs["jax"], runs["port"]
    assert tseen == jseen
    assert {k: (len(v) if k == "tokens" else v) for k, v in tseen.items()
            if k in want} == want
    assert tseen["fired"] == 1 and tseen["used_pages"] == 0
    _same(jr, tr)
    d = tr.deltas()
    if point == "serve.admit":
        assert d[("oim_serve_requests_total", ("rejected",))] == 1
    if point == "spec.propose":
        assert tseen["proposed"] == 0  # the first request decoded plainly
    if want["reason"] == "error":
        assert d[("oim_serve_requests_total", ("error",))] == 1
        assert [(e.type, e.attrs["reason"]) for e in tr.events()] == [("slot_evicted", "error")]


def test_queue_full_and_pool_exhaustion_match_jax(model):
    """The real refusal and a pool that cannot cover the queue head: a
    rejected count and one page_pool_exhausted event per episode."""
    runs = {}
    for pkg in PKGS:
        reads = Reads(pkg)
        eng = _engine(pkg, model, queue_depth=1, kv_pool_tokens=32, prefix_cache_bytes=0)
        gate = threading.Event()
        orig = eng._emit

        def slow_emit(req, token, orig=orig, gate=gate):
            orig(req, token)
            gate.wait(30)  # holds the engine thread: the queue stays full

        eng._emit = slow_emit
        first = eng.submit(PROMPT_A, max_new=10)   # 4 pages of 8 tokens: the whole pool
        seen = []
        deadline = time.monotonic() + 30
        while eng.queue_len and time.monotonic() < deadline:
            time.sleep(0.001)                      # until the engine picks it up
        queued = eng.submit(PROMPT_B, max_new=2)
        try:
            eng.submit(PROMPT_CANCEL, max_new=2)
        except pkg.engine.QueueFull:
            seen.append("rejected")
        gate.set()
        seen += [first.result(timeout=60) and first.finish_reason,
                 queued.result(timeout=60) and queued.finish_reason]
        eng.stop(quiet=True)
        runs[pkg.name] = (reads, seen)
    (jr, jseen), (tr, tseen) = runs["jax"], runs["port"]
    assert tseen == jseen == ["rejected", "length", "length"]
    _same(jr, tr)
    assert tr.deltas()[("oim_serve_requests_total", ("rejected",))] == 1
    assert [e.type for e in tr.events()] == ["page_pool_exhausted"]


def test_autopsy_reads_the_ports_spans_as_it_reads_jax(model):
    reports = {}
    for pkg in PKGS:
        eng = _engine(pkg, model)
        srv = pkg.M.MetricsServer(port=0).start()
        try:
            with pkg.tracing.start_span("serve.generate") as root:
                h = eng.submit(PROMPT_A, max_new=5)
                h.result(timeout=60)
            eng.stop(quiet=True)
            rendered = pkg.M.DEFAULT.render(exemplars=True)
            collected = autopsy.collect(root.trace_id, [f"127.0.0.1:{srv.port}"])
            tcollected = tautopsy.collect(root.trace_id, [f"127.0.0.1:{srv.port}"])
        finally:
            srv.stop()
        assert f'trace_id="{root.trace_id}"' in rendered
        assert tcollected == collected
        reports[pkg.name] = autopsy.analyze(collected)
        assert tautopsy.analyze(tcollected) == reports[pkg.name]
        assert tautopsy.render(reports[pkg.name]) == autopsy.render(reports[pkg.name])
    jrep, trep = reports["jax"], reports["port"]
    assert trep["root"] == jrep["root"] == "serve.generate"
    shape = [(p["name"], p["detail"].split(",")[0]) for p in trep["phases"]]
    assert shape == [(p["name"], p["detail"].split(",")[0]) for p in jrep["phases"]]
    assert shape == [("admission queue", ""), ("prefill", "20 prompt tokens"),
                     ("decode", "4 tokens")]
    assert trep["unreachable"] == [] and 0 < trep["coverage"] <= 1.0


# ----------------------------------------------------------------- staging ----


def _stage_twice_and_evict(backend, vol_cls, params, spec):
    for _ in range(2):
        vol = vol_cls("vol", b"", spec)
        backend.stage(vol, "file", params)
        assert vol.wait(60) and not vol.error, vol.error
        backend.unstage(vol)
    return backend.cache.evict_idle(), backend.cache.stats()


@pytest.mark.parametrize("pair", ["malloc", "device"])
def test_backends_record_equal_deltas(tmp_path, pair):
    data = np.random.RandomState(3).randint(0, 1 << 16, (64, 96)).astype(np.int32)
    np.save(tmp_path / "v.npy", data)
    path = str(tmp_path / "v.npy")
    runs = {}
    for pkg in PKGS:
        reads = Reads(pkg)
        if pkg is JAX:
            backend = JMallocBackend() if pair == "malloc" else TPUBackend()
            freed, stats = _stage_twice_and_evict(backend, JStagedVolume,
                                                  pb.FileParams(path=path, format="npy"),
                                                  pb.ArraySpec())
        else:
            backend = MallocBackend() if pair == "malloc" else \
                CUDABackend(device="cpu", chunk_bytes=4096)
            freed, stats = _stage_twice_and_evict(backend, StagedVolume,
                                                  tspec.FileParams(path, "npy"),
                                                  tspec.ArraySpec())
        runs[pkg.name] = (reads, freed, {k: stats[k] for k in ("hits", "misses", "evictions")}
                          if "hits" in stats else None)
    (jr, jfreed, _), (tr, tfreed, tstats) = runs["jax"], runs["port"]
    assert tfreed == jfreed == data.nbytes
    _same(jr, tr)
    d = tr.deltas()
    # The plane reads the device backends' file through read_into; the
    # malloc backends load it whole with numpy, in both packages.
    assert d.get(("oim_staged_bytes_total", ())) == (data.nbytes if pair == "device" else None)
    assert (d[("oim_stage_cache_hits_total", ())], d[("oim_stage_cache_misses_total", ())],
            d[("oim_stage_cache_evictions_total", ())]) == (1, 1, 1)
    assert tstats == {"hits": 1, "misses": 1, "evictions": 1}
    assert d[("oim_stage_seconds_total", ())] > 0 and jr.deltas()[
        ("oim_stage_seconds_total", ())] > 0
    ev = tr.events()
    assert [e.type for e in ev] == ["stage_cache_eviction"]
    assert ev[0].attrs["bytes"] == data.nbytes and ev[0].attrs["still_pinned"] is False
    assert [s.name for s in tr.spans()] == ["stage", "stage"]
    assert tr.spans()[0].attrs == {"volume": "vol", "kind": "file"}
    assert tr.gauge("STAGE_CACHE_ENTRIES") == 0 and tr.gauge("STAGE_CACHE_BYTES") == 0


class _Objects(http.server.BaseHTTPRequestHandler):
    """HEAD and ranged GET over ``server.objects``."""

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        data = self.server.objects[self.path]
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_GET(self):
        data = self.server.objects[self.path]
        lo, _, hi = self.headers["Range"][len("bytes="):].partition("-")
        body = data[int(lo):int(hi) + 1]
        self.send_response(206)
        self.send_header("Content-Range", f"bytes {lo}-{int(lo) + len(body) - 1}/{len(data)}")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def objects():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Objects)
    srv.daemon_threads = True
    srv.objects = {}
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_read_engines_and_object_reads_record_equal_bytes(tmp_path, objects):
    data = np.random.RandomState(5).bytes(300_000)
    (tmp_path / "f.bin").write_bytes(data)
    objects.objects["/b/o"] = data
    url = f"http://127.0.0.1:{objects.server_port}/b/o"
    runs = {}
    for pkg, staging, store in ((JAX, jstaging, jobjectstore), (PORT, tstaging, tobjectstore)):
        reads = Reads(pkg)
        dst = np.empty(100_000, np.uint8)
        staging.read_into(str(tmp_path / "f.bin"), dst, offset=50_000)
        streamed = b"".join(bytes(c) for c in staging.stream(str(tmp_path / "f.bin"),
                                                              chunk_bytes=65536))
        whole = store.read_object(url, part_bytes=65536, n_threads=2)
        part = np.empty(70_000, np.uint8)
        store.read_range(url, 1000, 70_000, part, part_bytes=32768, n_threads=2,
                         expected_total=len(data))
        assert dst.tobytes() == data[50_000:150_000] and streamed == data
        assert whole.tobytes() == data and part.tobytes() == data[1000:71_000]
        runs[pkg.name] = reads
    _same(runs["jax"], runs["port"])
    assert runs["port"].deltas() == {("oim_staged_bytes_total", ()):
                                     100_000 + 300_000 + 300_000 + 70_000}
    assert runs["port"].gauge("STAGE_GBPS") > 0


@pytest.mark.parametrize("engine", tstaging.ENGINES)
def test_every_read_engine_counts_its_bytes(tmp_path, engine):
    """Each engine there is counts what it read and sets the rate; an
    engine that is not there raises and counts nothing."""
    there = {"native": tstaging.native_lib() is not None,
             "io_uring": tstaging.io_uring_available(), "preadv": True}[engine]
    (tmp_path / "f.bin").write_bytes(bytes(range(256)) * 64)
    tmetrics.STAGE_GBPS.set(0)
    reads = Reads(PORT)
    dst = np.empty(8192, np.uint8)
    if not there:
        with pytest.raises(tstaging.StagingError):
            tstaging.read_into(str(tmp_path / "f.bin"), dst, engine=engine)
        assert reads.deltas() == {} and tmetrics.STAGE_GBPS.value == 0
        return
    tstaging.read_into(str(tmp_path / "f.bin"), dst, 4096, engine=engine)
    assert reads.deltas() == {("oim_staged_bytes_total", ()): 8192}
    assert dst.tobytes() == (bytes(range(256)) * 64)[4096:4096 + 8192]
    assert tmetrics.STAGE_GBPS.value > 0


# ----------------------------------------------------------------- trainer ----


@pytest.mark.parametrize("model_name", ["llama-tiny", "llama-tiny-moe"])
def test_trainer_gauges_and_spans_match_jax(model_name):
    common = dict(model=model_name, batch_size=2, seq_len=8, lr=1e-2, warmup_steps=1,
                  total_steps=2, log_every=1, seed=3, eval_steps=1)
    jcfg, tcfg = jtrainer.TrainConfig(**common), ttrainer.TrainConfig(**common)
    jr = Reads(JAX)
    jtr = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    jtr.init_or_resume()
    init = jax.tree.map(np.asarray, jtr.state.params)
    jtr.run(steps=2)
    jgauges = {g: jr.gauge(g) for g in ("MOE_DROP_FRAC", "TRAIN_STEP_SECONDS",
                                        "TRAIN_EXAMPLES_PER_SEC", "TRAIN_MFU")}
    jeval = jtr.evaluate(jtrainer.synthetic_batches(dataclasses.replace(jcfg, seed=9)), 1)
    tr = Reads(PORT)
    ttr = ttrainer.Trainer(tcfg, device="cpu")
    ttr.init(tllama.from_numpy(init, device="cpu"))
    ttr.run(steps=2)
    last = ttr.history[-1]
    assert tr.gauge("TRAIN_STEP_SECONDS") == last["step_s"] > 0
    assert tr.gauge("TRAIN_EXAMPLES_PER_SEC") == 2 / last["step_s"]
    assert tr.gauge("FEED_WAIT_SECONDS") == last["feed_wait_s"]
    assert tr.gauge("TRAIN_MFU") == last["mfu"] == jgauges["TRAIN_MFU"] == 0.0
    if model_name == "llama-tiny-moe":
        assert tr.gauge("MOE_DROP_FRAC") == last["moe_drop_frac"]
        np.testing.assert_allclose(last["moe_drop_frac"], jgauges["MOE_DROP_FRAC"],
                                   atol=1e-7)
    teval = ttr.evaluate(ttrainer.synthetic_batches(dataclasses.replace(tcfg, seed=9)), 1)
    assert tr.gauge("EVAL_LOSS") == teval and jr.gauge("EVAL_LOSS") == jeval
    np.testing.assert_allclose(teval, jeval, atol=1e-4)
    for reads in (jr, tr):
        steps = [s for s in reads.spans() if s.name == "train.step"]
        assert [s.attrs for s in steps] == [{"step": 1}, {"step": 2}]


# ------------------------------------------------------- drift and lists ----


def _names(pattern, paths):
    found = set()
    for p in paths:
        found |= set(re.findall(pattern, (_ROOT / p).read_text()))
    return found


def test_every_family_the_port_declares_is_recorded_by_the_port():
    metrics_py = _ROOT / "oim_tpu_torch" / "common" / "metrics.py"
    declared = [n.targets[0].id for n in ast.parse(metrics_py.read_text()).body
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                and isinstance(n.value.func, ast.Attribute)
                and getattr(n.value.func.value, "id", "") == "DEFAULT"]
    assert len(declared) == len(PORT_FAMILIES)
    sources = "".join(p.read_text() for p in (_ROOT / "oim_tpu_torch").rglob("*.py")
                      if p != metrics_py)
    assert [n for n in declared if not re.search(rf"\bM\.{n}\b", sources)] == []
    for const in ("REPLICA_DRAIN", "STAGE_CACHE_EVICTION", "SLOT_EVICTED",
                  "PAGE_POOL_EXHAUSTED", "SPEC_FALLBACK", "FEEDER_FAILOVER",
                  "VOLUME_HEALED"):
        assert re.search(rf"events\.emit\(events\.{const}\b", sources), const


def test_jax_families_at_the_ported_sites_are_the_ports_but_the_deferred():
    recorded = _names(r"\bM\.([A-Z][A-Z0-9_]+)\b", PORTED_SITES)
    port_declared = {n for n, v in vars(tmetrics).items() if isinstance(v, tmetrics.Counter)}
    assert set(DEFERRED_FAMILIES) <= recorded
    assert not set(DEFERRED_FAMILIES) & port_declared
    assert _names(r"\bM\.([A-Z][A-Z0-9_]+)\b", PORTED_SITES.values()) == \
        recorded - set(DEFERRED_FAMILIES) == port_declared


def test_jax_events_at_the_ported_sites_are_the_ports_but_the_deferred():
    emitted = _names(r"\bevents\.([A-Z][A-Z_]+)\b", PORTED_SITES)
    port = _names(r"\bevents\.([A-Z][A-Z_]+)\b", PORTED_SITES.values())
    assert set(DEFERRED_EVENTS) <= emitted
    assert port == emitted - set(DEFERRED_EVENTS)


def test_span_names_and_fault_points_are_jax_ones():
    spans = r"(?:start_span|record_phase)\(\s*\"([^\"]+)\""
    faults = r"faultinject\.fire\(\s*\"([^\"]+)\""
    port_files = [str(p.relative_to(_ROOT)) for p in (_ROOT / "oim_tpu_torch").rglob("*.py")]
    assert _names(spans, port_files) == _names(spans, PORTED_SITES) == {
        "serve.prefill", "serve.draft_prefill", "serve.queue_wait", "serve.decode",
        "stage", "train.step", "feeder.publish", "feeder.window", "serve.generate",
        "router.generate"}
    assert _names(faults, port_files) == _names(faults, PORTED_SITES) == {
        "serve.admit", "spec.propose", "serve.retire", "serve.decode",
        "controller.register", "controller.heartbeat", "feeder.rpc", "prestage.fanout",
        "proxy.dial", "registry.promote", "replication.apply", "quorum.campaign",
        "router.pick", "router.stream"}
