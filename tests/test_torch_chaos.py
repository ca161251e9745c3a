"""The port's chaos ladder (``oim_tpu_torch/chaos``) held against
``oim_tpu``'s on the CPU.

* The port's rung table equals JAX's (name, ``expect``, ``sim_kwargs``,
  ``slow``), the ``autoscale`` rung included; ``SMOKE_RUNGS`` equals
  JAX's. The ``autoscale`` rung itself converges in
  tests/test_torch_autoscale_rung.py.
* Each smoke rung converges over the port's engines, registry and router
  on the CPU: together their signatures are tests/test_chaos_smoke.py's
  list, each census ran, and the unarmed fault points are free
  (``fault_overhead_ratio >= 0.90``). The same seed gives the same
  signatures.
* The port's greedy ``solo_tokens``, with JAX's ``model()`` carried over,
  equals JAX's for the smoke rungs' greedy requests.
* In a fresh interpreter, ``run_engine_rungs`` runs the two engine rungs
  without loading grpc or protobuf.
* ``SimReplicaLauncher`` spawns, drains and joins against the port's
  registry.
* The slow rungs mirror tests/test_chaos.py's ``TestSlowRungs``.

The port draws its own weights (``sim.model``): its streams are held to
the port's own solo references, as JAX's are to JAX's.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oim_tpu.chaos import ladder as jladder
from oim_tpu.chaos import sim as jsim
from oim_tpu_torch import chaos
from oim_tpu_torch.chaos import ladder, sim
from oim_tpu_torch.chaos.ladder import _reqs
from oim_tpu_torch.chaos.sim import wait_for
from oim_tpu_torch.common import events
from oim_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parent.parent

# tests/test_chaos_smoke.py's signatures, in the ladder's order.
SMOKE_SIGNATURES = [
    ["replica_kill", "router_mark_failed", "router_retry"],
    ["channel_blackhole", "router_mark_failed", "router_retry"],
    ["pool_exhaustion", "page_pool_exhausted"],
    ["quorum_partition", "registry_election", "registry_promotion",
     "registry_stepdown"],
    ["registry_rolling_restart", "registry_election",
     "registry_promotion"],
    ["kv_peer_fetch", "kv_peer_fetch", "kv_fetch_fallback"],
    ["prefill_replica_kill", "kv_peer_fetch", "router_mark_failed",
     "kv_fetch_fallback"],
    ["shard_member_kill", "shard_member_lost",
     "shard_member_healed"],
]
SERVE_FREE = {"quorum_partition", "registry_rolling_restart"}


@pytest.fixture(autouse=True, scope="module")
def _watch_streams_end():
    """The registries' Watch handlers notice a stopped server at their next
    keepalive (2 s): wait them out, so no RPC of this file counts into a
    later one's metrics."""
    yield
    time.sleep(2.5)


def _shape(rung) -> tuple:
    return rung.name, tuple(rung.expect), rung.sim_kwargs, rung.slow


# --------------------------------------------------------------- tables ----


def test_rungs_equal_jax():
    assert [_shape(r) for r in ladder.RUNGS] == [_shape(r) for r in jladder.RUNGS]
    assert "autoscale" in {r.name for r in ladder.RUNGS}
    assert not hasattr(ladder, "DEFERRED_RUNGS")
    assert ladder.DEFAULT_SEED == jladder.DEFAULT_SEED


def test_smoke_rungs_equal_jax():
    assert ladder.SMOKE_RUNGS == jladder.SMOKE_RUNGS
    assert [r.name for r in ladder.RUNGS if r.name in ladder.SMOKE_RUNGS] == \
        [s[0] for s in SMOKE_SIGNATURES]


def test_selection_errors_match_jax():
    for mod in (ladder, jladder):
        with pytest.raises(ValueError, match="unknown rung"):
            mod.run_ladder(names=["no_such_rung"])
        with pytest.raises(ValueError, match="no rungs selected"):
            mod.run_ladder(names=["compound"], include_slow=False)
    with pytest.raises(ValueError, match="need the gRPC cluster"):
        ladder.run_engine_rungs(names=["pool_exhaustion", "replica_kill"], device="cpu")


def test_reqs_equal_jax():
    for name in ("replica_kill", "registry_promotion"):
        assert _reqs(random.Random(f"7:{name}"), 8) == \
            jladder._reqs(random.Random(f"7:{name}"), 8)


# ---------------------------------------------------------- smoke rungs ----


@pytest.mark.parametrize("expected", SMOKE_SIGNATURES, ids=[s[0] for s in SMOKE_SIGNATURES])
def test_smoke_rung_converges_on_the_cpu(expected):
    name = expected[0]
    report = ladder.run_ladder(include_slow=False, names=[name], device="cpu")
    [rung] = report["rungs"]
    assert report["event_signature"] == [expected]
    assert rung["healed"] == expected[1:]
    if name in SERVE_FREE:
        # Registry-only rungs: the census still ran (it checks the
        # channel pool), there are just no engines to audit.
        assert "pooled_channels" in rung["census"], rung
    else:
        assert rung["census"]["replicas"], rung  # census actually ran


def test_fault_points_are_free_when_unarmed():
    out = ladder.fault_overhead(device="cpu")
    assert out["fault_overhead_ratio"] >= 0.90, out
    assert out["fault_overhead_rounds"] == 6


def test_same_seed_same_signature():
    names = ["replica_kill", "pool_exhaustion"]
    a = ladder.run_ladder(seed=5, names=names, device="cpu")
    b = ladder.run_ladder(seed=5, names=names, device="cpu")
    assert a["event_signature"] == b["event_signature"] == [
        ["replica_kill", "router_mark_failed", "router_retry"],
        ["pool_exhaustion", "page_pool_exhausted"]]


# ------------------------------------------------------ solo references ----


def _greedy_requests(name: str) -> list:
    """The greedy requests a smoke rung's driver draws first from its
    seeded stream (``_run_replica_kill``, ``_run_channel_blackhole``,
    ``_run_pool_exhaustion``)."""
    rng = random.Random(f"{ladder.DEFAULT_SEED}:{name}")
    if name == "pool_exhaustion":
        reqs = [([rng.randrange(1, 64) for _ in range(24)], 17, 0.0,
                 rng.randrange(1 << 16)) for _ in range(6)]
    else:
        reqs = _reqs(rng, {"replica_kill": 8, "channel_blackhole": 6}[name])
    return [r for r in reqs if r[2] == 0.0]


@pytest.fixture(scope="module")
def carried():
    jp, _ = jsim.model()
    cfg = tllama.tiny(vocab=64, dim=32, n_layers=2)
    return tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), cfg


@pytest.mark.parametrize("name", ["replica_kill", "channel_blackhole", "pool_exhaustion"])
def test_greedy_solo_tokens_equal_jax(monkeypatch, carried, name):
    monkeypatch.setattr(sim, "model", lambda device="cuda": carried)
    reqs = _greedy_requests(name)
    assert len(reqs) >= 3
    for prompt, n_new, temp, seed in reqs:
        assert sim.solo_tokens(prompt, n_new, temperature=temp, seed=seed, device="cpu") == \
            jsim.solo_tokens(prompt, n_new, temperature=temp, seed=seed)


def test_sampled_solo_tokens_are_the_engines_stream():
    """A sampled request's reference draws from the engine's own seeding:
    the engine's stream equals it, and another seed gives another."""
    from oim_tpu_torch.serve import ServeEngine

    params, cfg = sim.model("cpu")
    eng = ServeEngine(params, cfg, max_batch=2, max_seq=64, device="cpu")
    try:
        got = eng.submit([5, 6, 7], max_new=12, temperature=0.9, seed=41).result(timeout=60)
    finally:
        eng.stop(drain=False, timeout=30)
    ref = sim.solo_tokens([5, 6, 7], 12, temperature=0.9, seed=41, device="cpu")
    assert got == ref
    assert sim.solo_tokens([5, 6, 7], 12, temperature=0.9, seed=42, device="cpu") != ref


def test_model_is_cached_per_device_and_drafts_differ():
    assert sim.model("cpu") is sim.model(torch.device("cpu"))
    (tp, _), (dp, _) = sim.model("cpu"), sim.draft_model("cpu")
    assert not torch.equal(tp["embed"], dp["embed"])


# ------------------------------------------------------- the card's core ----


def test_engine_rungs_load_no_grpc_in_a_fresh_interpreter():
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import oim_tpu_torch.chaos\n"
        "from oim_tpu_torch.chaos import ladder\n"
        "rep = ladder.run_engine_rungs(device='cpu')\n"
        "print(json.dumps(rep['event_signature']))\n"
        "print(json.dumps([r['census']['replicas']['r0']['used_pages'] for r in rep['rungs']]))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('grpc', 'jax', 'oim_tpu') or m.startswith('google.protobuf'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    sig, used, loaded = (json.loads(line) for line in out.stdout.strip().split("\n")[-3:])
    assert sig == [["pool_exhaustion", "page_pool_exhausted"],
                   ["draft_collapse", "spec_fallback"]]
    assert used == [0, 0]
    assert loaded == []


def test_engine_sim_stream_divergence_carries_both_streams():
    with sim.EngineSim(replicas=1, device="cpu") as s:
        ref = sim.solo_tokens([3, 4], 5, device="cpu")
        s.check_stream([3, 4], 5, 0.0, 0, ref, "same")
        with pytest.raises(sim.StreamDiverged) as err:
            s.check_stream([3, 4], 5, 0.0, 0, ref[:4] + [(ref[4] + 1) % 64], "planted")
        assert err.value.expect == ref and err.value.got[:4] == ref[:4]


# ------------------------------------------------------------- launcher ----


def test_sim_replica_launcher_spawns_drains_and_joins():
    with sim.ClusterSim(replicas=1, device="cpu") as s:
        prestaged = []
        launcher = sim.SimReplicaLauncher(s, prestage_fn=prestaged.append)
        rid = launcher.spawn("v2")
        assert rid == "as0" and s.replicas[-1].rid == "as0"
        assert wait_for(lambda: any(r.replica_id == "as0" and r.version == "v2"
                                    for r in s.table.replicas()), timeout=30), \
            "spawned replica never entered the routing table"
        assert launcher.spawn("v2") == "as1"
        assert prestaged == ["v2"]
        launcher.join()
        handle = s.replicas[-2]
        out = handle.engine.submit([1, 2, 3], max_new=4).result(timeout=60)
        assert out == sim.solo_tokens([1, 2, 3], 4, device="cpu")
        mark = s.mark_faults()
        launcher.drain("as0")
        launcher.join()
        assert not handle.alive
        assert wait_for(lambda: all(r.replica_id != "as0" for r in s.table.replicas()),
                        timeout=15), "drained replica never left the table"
        assert s.wait_heal([events.REPLICA_DRAIN], mark) == ["replica_drain"]
        census = s.leak_census()
        assert set(census["replicas"]) == {"r0", "as1"}


# ------------------------------------------------------------ slow rungs ----


@pytest.mark.slow
class TestSlowRungs:
    def test_compound_rung_converges(self):
        report = chaos.run_ladder(names=["compound"], device="cpu")
        [rung] = report["rungs"]
        assert rung["healed"] == [
            events.REGISTRY_PROMOTION, events.REPLICA_DRAIN,
            events.ROUTER_MARK_FAILED, events.ROUTER_RETRY]
        assert rung["details"]["survivor_served"] > 0

    def test_quorum_leader_kill_rung_converges(self):
        report = chaos.run_ladder(names=["quorum_leader_kill"], device="cpu")
        [rung] = report["rungs"]
        assert rung["healed"] == [
            events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION]
        assert rung["details"]["byte_identical"] > 0
        assert rung["details"]["election_term"] >= 2

    def test_restart_after_kill_rejoins_and_serves(self):
        with sim.ClusterSim(replicas=2, device="cpu") as s:
            s.warm()
            r1 = s.replicas[1]
            r1.kill()
            reqs = _reqs(random.Random("restart"), 4)
            results, errors = s.routed_load(reqs)
            assert not errors, f"client saw errors across the kill: " \
                               f"{errors[0]!r}"
            s.assert_byte_identity(reqs, results)

            r1.restart()
            assert wait_for(
                lambda: any(r.replica_id == "r1"
                            for r in s.table.replicas()),
                timeout=10), "restarted replica never re-entered the table"
            served_before = r1.completed()
            deadline = time.monotonic() + 30
            while r1.completed() == served_before:
                assert time.monotonic() < deadline, \
                    "no request reached the restarted replica"
                more = _reqs(random.Random("restart-2"), 2)
                results, errors = s.routed_load(more)
                assert not errors
                s.assert_byte_identity(more, results)

    def test_ladder_converges_across_seeds(self):
        assert (_reqs(random.Random("7:registry_promotion"), 8)
                != _reqs(random.Random("11:registry_promotion"), 8))
        chaos.run_ladder(seed=7, names=["registry_promotion"], device="cpu")
        chaos.run_ladder(seed=11, names=["registry_promotion"], device="cpu")

    def test_the_rest_of_the_ladder_converges(self):
        """Every rung that neither the smoke set nor the cases above run:
        its declared signature, byte-identity and census hold on the
        CPU."""
        names = ["registry_rolling_restart_lite", "feeder_failover", "draft_collapse"]
        report = chaos.run_ladder(names=names, device="cpu")
        assert report["event_signature"] == [
            [r.name, *r.expect] for r in ladder.RUNGS if r.name in names]
