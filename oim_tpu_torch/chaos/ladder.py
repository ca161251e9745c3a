"""The deterministic chaos ladder (``oim_tpu/chaos/ladder.py``): scripted
fault schedules ("rungs") over the in-process cluster sim, each ending in
a CONVERGENCE assertion, run over the port's engines, registry and router.

Each heal mechanism has its own unit test; this module proves they
CONVERGE — the expected heal events fire, in order,
on ``/debug/events`` (read over HTTP, the way an operator would), with
zero client-visible errors wherever the retry contract promises them,
byte-identical routed outputs, and a zero-leak page/prefix/channel
census at the end of every rung.

Determinism: each rung gets its own ``random.Random`` seeded from
``(ladder seed, rung name)`` — adding a rung never shifts another's
request stream — and every backoff in the process draws through the
same seeded stream (``common/backoff.use_rng``). A rung PASSES exactly
when its observed heal signature (first-occurrence order of the
expected event types) equals its declared ``expect`` tuple, so a
passing ladder's event sequence is identical run to run by
construction: same seed → same signature, or a loud assertion.

The rung table (ladder order):

==================  =================================  =================
rung                fault                              heal proven
==================  =================================  =================
replica_kill        SIGKILL 1 of 2 replicas mid-lease  retry-before-
                                                       first-token
channel_blackhole   listener dies, heartbeat lives     pool eviction +
                                                       redial
pool_exhaustion     long-prompt burst > page pool      backpressure, not
                                                       OOM or error
registry_promotion  SIGKILL the PRIMARY registry       standby auto-
                                                       promotion
quorum_leader_kill  SIGKILL the quorum LEADER under    majority election,
                    routed serve load                  writes resume,
                                                       zero human steps
quorum_partition    symmetric partition of the 3-node  minority steps
                    quorum, leader in the minority     down + rejects;
                                                       majority elects;
                                                       split-brain = 0
registry_rolling_   restart every member, leader       writes resume per
restart             last                               hop; ONE Watch
                                                       stream survives
feeder_failover     SIGKILL the pinned controller      feeder failover +
                                                       warm cache hit
draft_collapse      a draft that stops predicting      valve fallback,
                                                       byte-identity
kv_peer_fetch       prefix-holder + controller         peer adoption
                    SIGKILLed mid peer-fetch           first, then
                                                       fallback to local
                                                       recompute; byte-
                                                       identity; both
                                                       tiers census 0
prefill_replica_    SIGKILL the prefill-tier replica   router mark-failed
kill                mid-handoff (listener dies under   + plain routing;
                    the router's split stream; the     decode-local
                    export never publishes)            recompute after
                                                       the fleet fetch
                                                       misses; byte-
                                                       identity; zero
                                                       client errors
shard_member_kill   SIGKILL a non-rank-0 member of     lease lapse flips
                    a 2-way sharded replica            the replica not-
                    mid-stream                         ready; router
                                                       rotates to the
                                                       survivor; restage
                                                       = cache hit
autoscale           latency SLO fires under load;      alert -> scale-up;
                    leader autoscaler killed           standby takeover
                    mid-episode                        by lease; resolve
                                                       -> scale-down
compound [slow]     promotion + drain + prefix-holder  all of the above,
                                                       overlapped
==================  =================================  =================

The rungs that drive the engine alone (``ENGINE_RUNGS``: page-pool
exhaustion and the draft collapse) run through ``run_engine_rungs`` over
an ``EngineSim``, which needs neither grpcio nor protobuf, on any device:
that is the ladder's part that runs on the card. Every other rung routes,
registers or replicates over gRPC.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable

import numpy as np

from oim_tpu_torch.chaos.sim import (
    ClusterSim,
    EngineSim,
    model as sim_model,
    wait_for,
)
from oim_tpu_torch.common import backoff, events, metrics as M

DEFAULT_SEED = 1337


def _reqs(rng: random.Random, n: int, *, vocab: int = 64,
          prompt_len=(2, 8), max_new=(4, 8), temps=(0.0, 0.9),
          prefix=()) -> list:
    """A deterministic request batch from the rung's seeded stream."""
    out = []
    for i in range(n):
        prompt = list(prefix) + [
            rng.randrange(1, vocab)
            for _ in range(rng.randint(*prompt_len))]
        out.append((prompt, rng.randint(*max_new),
                    temps[i % len(temps)], rng.randrange(1 << 16)))
    return out


# ---------------------------------------------------------------------------
# Rungs.


def _run_replica_kill(sim: ClusterSim, rng: random.Random) -> dict:
    """SIGKILL one of two replicas: its TTL-leased row outlives it, the
    router keeps picking the corpse and must retry BEFORE the first
    token — zero client errors, byte-identical outputs."""
    sim.warm()
    reqs = _reqs(rng, 8)
    results, errors = sim.routed_load(reqs[:2])
    assert not errors, f"warm load failed: {errors[0]!r}"
    mark = sim.mark_faults()
    sim.replicas[1].kill()
    results, errors = sim.routed_load(reqs)
    assert not errors, f"client saw errors across the kill: {errors[0]!r}"
    checked = sim.assert_byte_identity(reqs, results)
    sim.wait_heal([events.ROUTER_MARK_FAILED, events.ROUTER_RETRY], mark)
    retries = [e for e in sim.debug_events(events.ROUTER_RETRY)
               if e["seq"] > mark]
    assert all(e.get("trace_id") for e in retries), \
        f"router_retry events missing trace stamps: {retries}"
    # The corpse leaves the table once its lease lapses.
    assert wait_for(
        lambda: all(r.replica_id != "r1" for r in sim.table.replicas()),
        timeout=10), "dead replica never left the routing table"
    return {"requests": len(reqs), "byte_identical": checked,
            "retries": len(retries)}


def _run_channel_blackhole(sim: ClusterSim, rng: random.Random) -> dict:
    """Black-holed endpoint: r1's listener dies but its heartbeat keeps
    the row fresh, so the router keeps dialing a dead socket — the
    channel pool must evict and, once the listener returns, the next
    pick must RE-DIAL (not ride the dead channel) and serve
    byte-identical output."""
    sim.warm()
    r1 = sim.replicas[1]
    addr = r1.server.addr

    def dials() -> int:
        return sum(n for (a, _), n in sim.pool.stats().items()
                   if a == addr)

    mark = sim.mark_faults()
    r1.kill_listener()
    reqs = _reqs(rng, 6)
    results, errors = sim.routed_load(reqs)
    assert not errors, f"client saw errors across the blackhole: " \
                       f"{errors[0]!r}"
    sim.assert_byte_identity(reqs, results)
    sim.wait_heal([events.ROUTER_MARK_FAILED, events.ROUTER_RETRY], mark)

    r1.restart_listener()
    # Snapshot AFTER the listener returns: dials made during the
    # blackhole (each failed attempt dials the dead socket before the
    # pool evicts it) would satisfy a pre-fault snapshot vacuously.
    # Every blackhole failure evicted its channel, so reaching the
    # recovered replica requires a fresh post-restart dial — that is
    # the redial this assert proves.
    dials_before = dials()
    r1.registration.beat_once()  # a CHANGED row clears the failure mark
    assert wait_for(
        lambda: any(r.replica_id == "r1" for r in sim.table.replicas()),
        timeout=10), "recovered replica never re-entered the table"
    # Keep offering load until a request actually lands on r1 through a
    # freshly dialed channel.
    served_before = r1.completed()
    deadline = time.monotonic() + 30
    extra = 0
    while r1.completed() == served_before:
        assert time.monotonic() < deadline, \
            "no request reached the recovered replica"
        more = _reqs(rng, 2)
        extra += len(more)
        results, errors = sim.routed_load(more)
        assert not errors
        sim.assert_byte_identity(more, results)
    assert dials() > dials_before, \
        "recovery never re-dialed: the pool rode a dead channel"
    return {"requests": len(reqs) + extra,
            "redials": dials() - dials_before}


def _run_pool_exhaustion(sim: EngineSim, rng: random.Random) -> dict:
    """A long-prompt burst wants more KV pages than the pool holds:
    admissions must WAIT (page_pool_exhausted + queueing), never OOM or
    error, and every page returns after the burst."""
    sim.warm()
    engine = sim.replicas[0].engine
    mark = sim.mark_faults()
    reqs = [([rng.randrange(1, 64) for _ in range(24)], 17, 0.0,
             rng.randrange(1 << 16)) for _ in range(6)]
    handles = [engine.submit(p, max_new=n, temperature=t, seed=s)
               for p, n, t, s in reqs]
    results = [h.result(timeout=300) for h in handles]
    for (prompt, n_new, temp, seed), toks in zip(reqs, results):
        sim.check_stream(prompt, n_new, temp, seed, toks,
                         "backpressured output diverged")
    assert all(h.finish_reason == "length" for h in handles)
    sim.wait_heal([events.PAGE_POOL_EXHAUSTED], mark)
    stats = engine.pool_stats()
    assert stats["used_pages"] == 0, f"pages leaked: {stats}"
    assert stats["peak_used_pages"] <= stats["total_pages"]
    return {"requests": len(reqs),
            "peak_used_pages": stats["peak_used_pages"],
            "total_pages": stats["total_pages"]}


def _run_registry_promotion(sim: ClusterSim, rng: random.Random) -> dict:
    """SIGKILL the PRIMARY registry: the standby auto-promotes after the
    primary lease lapses, registrations and the routing table rotate to
    it, and routed traffic converges back to clean. No routability
    contract covers the failover window itself — errors there are
    recorded, not asserted — but post-convergence load must be
    error-free and byte-identical."""
    sim.warm()
    reqs = _reqs(rng, 8)
    results, errors = sim.routed_load(reqs[:2])
    assert not errors, f"pre-fault load failed: {errors[0]!r}"
    mark = sim.mark_faults()
    sim.kill_registry_primary()
    # Load THROUGH the outage: the table's cached snapshot and the
    # standby's read path keep most picks routable.
    during, during_errors = sim.routed_load(reqs[2:5])
    sim.assert_byte_identity(reqs[2:5], during)
    sim.wait_heal([events.REGISTRY_PROMOTION], mark)
    # Convergence: every replica re-registered against the new primary.
    assert wait_for(lambda: len(sim.table) == sim.n_replicas, timeout=15), \
        "replicas never re-registered on the promoted standby"
    results, errors = sim.routed_load(reqs[5:])
    assert not errors, \
        f"post-promotion load saw errors: {errors[0]!r}"
    sim.assert_byte_identity(reqs[5:], results)
    promo = [e for e in sim.debug_events(events.REGISTRY_PROMOTION)
             if e["seq"] > mark]
    return {"requests": len(reqs),
            "during_outage_errors": len(during_errors),
            "promotion_epoch": promo[-1]["attrs"]["epoch"]}


def _run_feeder_failover(sim: ClusterSim, rng: random.Random) -> dict:
    """SIGKILL the pinned controller mid-volume: the feeder fails over
    to the same-coordinate replica, re-publishes (volume_healed), and —
    because the publish was prestaged to the standby — the restage is a
    stage-cache HIT, not a second disk scan."""
    from oim_tpu_torch.registry.registry import CONTROLLER_ID_META
    from oim_tpu_torch.spec import oim_pb2 as pb
    from oim_tpu_torch.spec.services import ControllerStub

    data = np.random.RandomState(rng.randrange(1 << 31)).bytes(50_000)
    path = sim.tmpfile(data)
    feeder = sim.feeder("host-0")
    request = pb.MapVolumeRequest(
        volume_id="chaos-vol",
        file=pb.FileParams(path=path, format="raw"))
    feeder.publish(request, timeout=60)
    w, total, _ = feeder.fetch_window("chaos-vol", 0, 10_000, heal=True)
    assert w.tobytes() == data[:10_000] and total == len(data)

    # Warm the standby (the prestage.fanout path), then wait for the
    # async stage to land: PrestageVolume answers already_cached once.
    assert feeder.prestage_replica(request) == "host-1"
    stub = ControllerStub(sim.pool.get(
        sim.registries[0][1].addr, None, "component.registry"))

    def warmed() -> bool:
        return stub.PrestageVolume(
            request, metadata=[(CONTROLLER_ID_META, "host-1")],
            timeout=10.0).already_cached

    assert wait_for(warmed, timeout=30), "standby prestage never landed"

    hits_before = M.STAGE_CACHE_HITS.value
    mark = sim.mark_faults()
    sim.controllers[0].kill()
    w2, total2, _ = feeder.fetch_window(
        "chaos-vol", 10_000, 20_000, timeout=60, heal=True)
    assert w2.tobytes() == data[10_000:30_000] and total2 == len(data)
    assert feeder.controller_id == "host-1"
    sim.wait_heal([events.FEEDER_FAILOVER, events.VOLUME_HEALED], mark)
    cache_hits = M.STAGE_CACHE_HITS.value - hits_before
    assert cache_hits >= 1, \
        "failover restage missed the prestaged cache (full restage paid)"
    return {"volume_bytes": len(data), "warm_standby_cache_hits": cache_hits}


def _run_draft_collapse(sim: EngineSim, rng: random.Random) -> dict:
    """A draft that stops predicting the traffic: the acceptance valve
    must close (spec_fallback), live rows release their draft pages,
    and greedy output stays byte-identical throughout the flip."""
    sim.warm()
    engine = sim.replicas[0].engine
    mark = sim.mark_faults()
    reqs = [([rng.randrange(1, 64) for _ in range(4)], 24, 0.0,
             rng.randrange(1 << 16)) for _ in range(3)]
    handles = [engine.submit(p, max_new=n, temperature=t, seed=s)
               for p, n, t, s in reqs]
    results = [h.result(timeout=300) for h in handles]
    for (prompt, n_new, temp, seed), toks in zip(reqs, results):
        sim.check_stream(prompt, n_new, temp, seed, toks,
                         "output diverged across the valve flip")
    sim.wait_heal([events.SPEC_FALLBACK], mark)
    spec = engine.spec_stats()
    assert spec["spec_on"] is False, "valve never closed"
    assert spec["draft_used_pages"] == 0, f"draft pages leaked: {spec}"
    return {"requests": len(reqs),
            "draft_peak_used_pages": spec["draft_peak_used_pages"]}


def _run_kv_peer_fetch(sim: ClusterSim, rng: random.Random) -> dict:
    """The fleet KV tier under fire: r0 exports a hot prefix chain as
    a content-addressed volume, r1 adopts it over the data path
    (kv_peer_fetch), then the prefix-holder AND its controller are
    SIGKILLed mid-fetch — the broken fetch must fall back to plain
    local recompute (kv_fetch_fallback), byte-identical to solo
    generate(), with both tiers census-clean at the end."""
    from oim_tpu_torch.serve.kvvolume import (
        PeerPrefixFetcher,
        config_fingerprint,
        export_chain,
    )

    sim.warm()
    r0, r1 = sim.replicas[0], sim.replicas[1]
    prefix = [rng.randrange(1, 64) for _ in range(32)]  # 2 full blocks
    r0.engine.submit(prefix + [9], max_new=2, seed=1).result(timeout=300)
    chains = r0.engine.hot_chains(1)
    assert chains and len(chains[0]) == 2, \
        f"holder never recorded the 2-block chain: {chains}"
    chain = list(chains[0])
    feeder = sim.feeder("host-0")
    volume_id = export_chain(r0.engine, feeder, chain)
    assert volume_id, "export found the chain already evicted"

    # The adopter's fetch path: its OWN feeder (registry mode — the
    # remote ReadVolume window path, exactly what a real peer pays).
    fetcher = PeerPrefixFetcher(
        sim.feeder("host-0"),
        config_fingerprint(r1.engine.cfg, r1.engine.page_tokens))
    r1.engine.set_kv_fetch(fetcher)
    mark = sim.mark_faults()

    # Phase 1 — adoption: r1 never held the prefix, so admission must
    # fetch the peer's finished pages (greedy + sampled, both pinned
    # to solo generate()).
    phase1 = [(prefix + [10], 4, 0.0, 7),
              (prefix + [12, 13], 4, 0.9, rng.randrange(1 << 16))]
    for prompt, n_new, temp, seed in phase1:
        toks = r1.engine.submit(
            prompt, max_new=n_new, temperature=temp,
            seed=seed).result(timeout=300)
        sim.check_stream(prompt, n_new, temp, seed, toks,
                         "adopted output diverged")
    adopted = [e for e in sim.debug_events(events.KV_PEER_FETCH)
               if e["seq"] > mark]
    assert adopted and adopted[0]["attrs"]["blocks"] == 2, \
        f"peer adoption never fired: {adopted}"

    # Phase 2 — the holder dies mid-fetch: evict r1's HBM tier (the
    # chain demotes D2H into its host tier) and the host tier too, so
    # the next admission MUST go back to the fleet — where the fetch
    # wrapper SIGKILLs the controller and the holder before reading.
    assert r1.engine.evict_prefix_store() > 0, "nothing to demote"
    host = r1.engine.host_stats()
    assert host["demotions"] > 0, f"eviction never demoted D2H: {host}"
    assert r1.engine.evict_host_tier() > 0, "host tier was empty"

    def killing_fetch(chain_arg, m):
        sim.controllers[0].kill()
        r0.kill()
        return fetcher(chain_arg, m)

    r1.engine.set_kv_fetch(killing_fetch)
    prompt = prefix + [11]
    toks = r1.engine.submit(
        prompt, max_new=4, temperature=0.0, seed=3).result(timeout=300)
    sim.check_stream(prompt, 4, 0.0, 3, toks,
                     "fallback output diverged (misaligned resume?)")
    sim.wait_heal([events.KV_FETCH_FALLBACK], mark)
    return {"volume": volume_id,
            "adopted_blocks": adopted[0]["attrs"]["blocks"],
            "host_demotions": host["demotions"],
            "requests": len(phase1) + 1}


def _run_prefill_replica_kill(sim: ClusterSim, rng: random.Random) -> dict:
    """Disaggregation under fire: r0 is the prefill tier (chunked
    prefill, retire exports the chain), r1 the decode tier (adopts
    shipped chains). Phase 1 proves the healthy split end to end; in
    phase 2 the prefill replica is SIGKILLed MID-HANDOFF — its
    listener dies while the router's synthetic prefill stream is in
    flight and the export never completes — so the router must mark
    it failed and fall back to plain routing, and the decode tier,
    finding no shipped volume for the new chain, must fall back to
    local recompute (kv_fetch_fallback): zero client-visible errors,
    byte-identity throughout, zero-leak census on the survivor."""
    from oim_tpu_torch.serve.kvvolume import (
        PeerPrefixFetcher,
        config_fingerprint,
        export_chain,
    )

    sim.warm()
    r0, r1 = sim.replicas[0], sim.replicas[1]
    feeder = sim.feeder("host-0")
    r0.engine.set_handoff_export(
        lambda eng, hashes: export_chain(eng, feeder, hashes))
    r1.engine.set_kv_fetch(PeerPrefixFetcher(
        sim.feeder("host-0"),
        config_fingerprint(r1.engine.cfg, r1.engine.page_tokens)))
    mark = sim.mark_faults()

    # Phase 1 — the healthy split: one routed long prompt runs its
    # prompt on r0 (chunked), the retire hook ships the chain, and the
    # stream lands on r1, which adopts the shipped pages instead of
    # recomputing (greedy, pinned to solo generate()).
    prompt = [rng.randrange(1, 64) for _ in range(33)]  # 2 full blocks
    reqs = [(prompt, 4, 0.0, 7)]
    results, errors = sim.routed_load(reqs, concurrency=1)
    assert not errors, f"healthy split round errored: {errors}"
    assert sim.assert_byte_identity(reqs, results) == len(reqs)
    adopted = [e for e in sim.debug_events(events.KV_PEER_FETCH)
               if e["seq"] > mark]
    assert adopted and adopted[0]["attrs"]["blocks"] == 2, \
        f"decode tier never adopted the shipped chain: {adopted}"

    # Phase 2 — SIGKILL mid-handoff: the export hook now kills r0's
    # listener and heartbeat BEFORE raising, ON the engine thread —
    # the synthetic prefill stream the router is draining dies under
    # it deterministically, and the volume is never published. The
    # client request must still finish byte-identical: router
    # mark-failed + plain routing, then decode-local recompute after
    # the fleet fetch finds nothing.
    def killing_export(eng, hashes):
        r0.registration.stop(deregister=False)
        r0.server.force_stop()
        r0.alive = False
        raise ConnectionError("prefill replica SIGKILLed mid-handoff")

    r0.engine.set_handoff_export(killing_export)
    prompt2 = [rng.randrange(1, 64) for _ in range(33)]
    reqs2 = [(prompt2, 4, 0.9, rng.randrange(1 << 16))]
    results2, errors2 = sim.routed_load(reqs2, concurrency=1)
    assert not errors2, \
        f"client saw the prefill replica die: {errors2}"
    assert sim.assert_byte_identity(reqs2, results2) == len(reqs2)
    sim.wait_heal([events.ROUTER_MARK_FAILED,
                   events.KV_FETCH_FALLBACK], mark)
    # Finish the corpse (kill() semantics minus the parts the hook
    # already did): the engine itself must not survive the rung.
    r0.engine.stop(drain=False, timeout=30, quiet=True)
    return {"requests": len(reqs) + len(reqs2),
            "adopted_blocks": adopted[0]["attrs"]["blocks"],
            "survivor": r1.rid}


def _run_compound(sim: ClusterSim, rng: random.Random) -> dict:
    """The production-shaped rung: a registry promotion WHILE a replica
    drains WHILE the prefix-holder dies, under same-prefix client load.
    Each heal must fire in schedule order and the surviving replica
    absorbs everything — zero errors in every window the contract
    covers, byte-identity throughout, zero-leak census at the end."""
    sim.warm()
    prefix = [rng.randrange(1, 64) for _ in range(32)]
    r0 = sim.replicas[0]
    # Seed the shared prefix on r0 and advertise it (retiring slots
    # donate; the next beat publishes the chain hashes).
    r0.engine.submit(prefix + [9, 8], max_new=4, seed=1).result(timeout=300)
    r0.registration.beat_once()
    assert wait_for(
        lambda: any(r.replica_id == "r0" and r.prefix_hashes
                    for r in sim.table.replicas()), timeout=10), \
        "prefix advertisement never reached the routing table"

    waves = [_reqs(rng, 4, prefix=prefix, temps=(0.0,), prompt_len=(2, 4),
                   max_new=(4, 6)) for _ in range(4)]
    mark = sim.mark_faults()

    # Wave 1 rides through the registry kill window.
    sim.kill_registry_primary()
    w1_results, w1_errors = sim.routed_load(waves[0])
    sim.assert_byte_identity(waves[0], w1_results)
    sim.wait_heal([events.REGISTRY_PROMOTION], mark)
    assert wait_for(lambda: len(sim.table) == sim.n_replicas, timeout=15), \
        "replicas never re-registered on the promoted standby"

    # Wave 2 rides through r1's graceful drain (launched concurrently):
    # the drain announcement + retry contract promise zero errors here.
    drainer = threading.Thread(target=sim.replicas[1].drain, daemon=True)
    drainer.start()
    w2_results, w2_errors = sim.routed_load(waves[1])
    drainer.join(timeout=60)
    assert not w2_errors, \
        f"drain window leaked a client error: {w2_errors[0]!r}"
    sim.assert_byte_identity(waves[1], w2_results)
    sim.wait_heal([events.REGISTRY_PROMOTION, events.REPLICA_DRAIN], mark)
    assert wait_for(
        lambda: all(r.replica_id != "r1" for r in sim.table.replicas()),
        timeout=15), "drained replica never left the table"

    # Wave 3: the prefix-holder dies; its row outlives it, so the
    # router must retry off the corpse — zero errors promised.
    sim.replicas[0].kill()
    w3_results, w3_errors = sim.routed_load(waves[2])
    assert not w3_errors, \
        f"prefix-holder kill leaked a client error: {w3_errors[0]!r}"
    sim.assert_byte_identity(waves[2], w3_results)
    signature = sim.wait_heal(
        [events.REGISTRY_PROMOTION, events.REPLICA_DRAIN,
         events.ROUTER_MARK_FAILED, events.ROUTER_RETRY], mark)

    # Wave 4: converged — the survivor serves everything, still
    # byte-identical (prefix recomputed, not resurrected).
    w4_results, w4_errors = sim.routed_load(waves[3])
    assert not w4_errors, f"post-convergence errors: {w4_errors[0]!r}"
    sim.assert_byte_identity(waves[3], w4_results)
    survivor = sim.replicas[2]
    assert survivor.completed() > 0, "survivor served nothing"
    return {"waves": len(waves),
            "during_promotion_errors": len(w1_errors),
            "survivor_served": survivor.completed(),
            "signature": signature}


def _run_quorum_leader_kill(sim: ClusterSim, rng: random.Random) -> dict:
    """SIGKILL the quorum LEADER under live routed serve load: the
    surviving majority elects with ZERO human intervention, writes
    resume through the endpoint list, and the client contract holds —
    zero visible errors, byte-identical outputs (the serve data path
    and the table's cached/pushed view never depended on the corpse)."""
    sim.warm()
    reqs = _reqs(rng, 10)
    results, errors = sim.routed_load(reqs[:2])
    assert not errors, f"pre-fault load failed: {errors[0]!r}"
    assert sim.registry_write("chaos/pre-kill", "1"), \
        "pre-fault write failed"
    mark = sim.mark_faults()
    sim.kill_registry_leader()
    # Load straight THROUGH the leaderless window: zero client errors
    # promised — routing never touches the registry on the data path.
    results, errors = sim.routed_load(reqs[2:])
    assert not errors, \
        f"client saw errors across the leader kill: {errors[0]!r}"
    checked = sim.assert_byte_identity(reqs[2:], results)
    healed = sim.wait_heal(
        [events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION], mark)
    # Writes resume with no human in the loop.
    assert wait_for(lambda: sim.registry_write("chaos/post-kill", "1"),
                    timeout=15), "writes never resumed post-election"
    # The routing view converges on the survivors' registry.
    assert wait_for(lambda: len(sim.table) == sim.n_replicas,
                    timeout=15), \
        "replica rows never converged on the new leader"
    promo = [e for e in sim.debug_events(events.REGISTRY_PROMOTION)
             if e["seq"] > mark]
    return {"requests": len(reqs), "byte_identical": checked,
            "election_term": promo[-1]["attrs"]["epoch"],
            "signature": healed}


def _run_quorum_partition(sim: ClusterSim, rng: random.Random) -> dict:
    """Symmetric partition, the replicated pair's unsolvable case: the
    minority-side leader steps down and REJECTS writes, the majority
    elects, and heal re-syncs by snapshot — with the split-brain write
    census pinned at 0 (no key acknowledged on both sides, ever)."""
    import grpc

    from oim_tpu_torch.spec import oim_pb2 as pb
    from oim_tpu_torch.spec.services import RegistryStub

    assert sim.registry_write("chaos/pre-partition", "1")
    watcher = sim.registry_watcher("chaos")
    assert wait_for(lambda: watcher.get("chaos/pre-partition") == "1",
                    timeout=10), "watch stream never synced"
    leader = sim.registry_leader()
    assert leader is not None
    old_mgr = leader[2]
    mark = sim.mark_faults()
    sim.partition_registry([old_mgr.node_id])

    # The majority elects first (step-down grace > election window)...
    sim.wait_heal([events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION],
                  mark, timeout=20)
    # ...then the minority leader notices majority silence and demotes.
    sim.wait_heal([events.REGISTRY_STEPDOWN], mark, timeout=20)

    # Split-brain write census: distinct keys offered to both sides.
    acked_minority, acked_majority = set(), set()
    minority_stub = RegistryStub(sim.pool.get(
        leader[1].addr, None, "component.registry"))
    try:
        minority_stub.SetValue(pb.SetValueRequest(value=pb.Value(
            path="chaos/split-minority", value="m")), timeout=5.0)
        acked_minority.add("chaos/split-minority")
    except grpc.RpcError as err:
        assert err.code() in (grpc.StatusCode.FAILED_PRECONDITION,
                              grpc.StatusCode.UNAVAILABLE), err
    new_leader = next(
        (n for n in sim.registries
         if n[2] is not None and n[2] is not old_mgr
         and n[2].role == "LEADER"), None)
    assert new_leader is not None, "majority side never elected"
    RegistryStub(sim.pool.get(
        new_leader[1].addr, None, "component.registry")).SetValue(
        pb.SetValueRequest(value=pb.Value(
            path="chaos/split-majority", value="M")), timeout=10.0)
    acked_majority.add("chaos/split-majority")
    census = acked_minority & acked_majority
    assert not census, f"split-brain: acked on both sides: {census}"
    assert not acked_minority, \
        "the partitioned minority leader acknowledged a write"

    # Heal: the old leader rejoins as follower and resyncs — the
    # majority's write appears on it, the never-acked one nowhere.
    sim.heal_registry_partition()
    assert wait_for(
        lambda: old_mgr.role == "FOLLOWER"
        and old_mgr.db.get("chaos/split-majority") == "M", timeout=20), \
        "healed minority never resynced the majority's writes"
    assert old_mgr.db.get("chaos/split-minority") == "", \
        "a never-acknowledged minority write survived the heal"
    # The watch stream rode the partition out (re-targeted as needed).
    assert wait_for(
        lambda: watcher.get("chaos/split-majority") == "M", timeout=15), \
        "watch stream never observed the majority write"
    return {"census_acked_both": len(census),
            "minority_acks": len(acked_minority),
            "watch_resyncs": watcher.resyncs}


def _run_registry_rolling_restart(sim: ClusterSim,
                                  rng: random.Random) -> dict:
    """Rolling restart of every quorum member, followers first and the
    leader last: writes resume after each hop (follower restarts lose
    no availability; the leader restart costs one election) and ONE
    Watch stream survives the whole roll with every marker row
    delivered — zero missed deltas across three snapshot/token
    resumes."""
    assert sim.registry_write("chaos/roll-0", "ok", lease_seconds=0)
    watcher = sim.registry_watcher("chaos")
    assert wait_for(lambda: watcher.get("chaos/roll-0") == "ok",
                    timeout=10), "watch stream never synced"
    mark = sim.mark_faults()
    leader = sim.registry_leader()
    order = [i for i, node in enumerate(sim.registries)
             if node is not leader] + [sim.registries.index(leader)]
    for hop, index in enumerate(order, start=1):
        sim.restart_registry_node(index)
        marker = f"chaos/roll-{hop}"
        assert wait_for(lambda m=marker: sim.registry_write(m, "ok"),
                        timeout=20), f"writes never resumed after hop {hop}"
        assert wait_for(lambda m=marker: watcher.get(m) == "ok",
                        timeout=20), \
            f"watch stream missed {marker} across the restart"
    # Every marker still visible on every live member's committed view.
    for i, (svc, _, mgr) in enumerate(sim.registries):
        for hop in range(len(order) + 1):
            assert wait_for(
                lambda s=svc, h=hop: s.db.get(f"chaos/roll-{h}") == "ok",
                timeout=15), f"member {i} missing chaos/roll-{hop}"
    healed = sim.wait_heal(
        [events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION], mark)
    return {"hops": len(order), "watch_resyncs": watcher.resyncs,
            "puts_seen": watcher.puts_seen, "signature": healed}


def _run_rolling_restart_lite(sim: ClusterSim, rng: random.Random) -> dict:
    """The rolling-restart schedule re-run under a 100-replica lite
    fleet's live heartbeat fan-in: every quorum member restarts while
    ~50 serve-row renewals per second keep committing, and the fleet
    must ride the roll out — every ``serve/`` row still live in a Watch
    view afterwards (leases renewed across each hop, no replica
    silently expired), on top of the base rung's zero-missed-deltas
    marker assertions."""
    fleet_view = sim.registry_watcher("serve")
    assert wait_for(lambda: len(fleet_view.rows) == sim.n_lite,
                    timeout=30), \
        f"lite fleet never fully registered: {len(fleet_view.rows)}"
    report = _run_registry_rolling_restart(sim, rng)
    assert wait_for(lambda: len(fleet_view.rows) == sim.n_lite,
                    timeout=30), \
        f"serve rows lost across the roll: {len(fleet_view.rows)} " \
        f"of {sim.n_lite}"
    report["lite_replicas"] = sim.n_lite
    report["lite_beat_errors"] = sim.lite.beat_errors
    return report


def _run_autoscale(sim: ClusterSim, rng: random.Random) -> dict:
    """The thesis rung, the full closed loop: routed load saturates a
    one-slot fleet, the monitor's burn-rate alert fires, the LEADER
    autoscaler scales up through the sim's ReplicaLauncher seam — then
    dies mid-episode, and the STANDBY claims the fleet row once the
    leader's beat freezes, finishes the scale-up it inherited, and
    rides the resolve into an idle scale-down. Zero client-visible
    errors and byte-identical outputs across every wave; the alert, the
    actuation, the takeover, the resolve and the decay all land in
    declared order on /debug/events."""
    from oim_tpu_torch.autoscale import Autoscaler, FleetSpec
    from oim_tpu_torch.chaos.sim import SimReplicaLauncher, solo_tokens
    from oim_tpu_torch.common.metrics import Registry
    from oim_tpu_torch.common.telemetry import TelemetryRegistration
    from oim_tpu_torch.obs.monitor import FleetMonitor
    from oim_tpu_torch.obs.slo import SLO, SloEngine

    sim.warm()
    probe_rng = random.Random(rng.randrange(1 << 31))
    # A small pool of UNIQUE requests cycled for the episode's whole
    # duration: the identity sweep replays each unique request through
    # solo generate() exactly once (a solo run costs ~a second on CPU,
    # and each distinct shape a jit compile), then holds every routed
    # occurrence to that reference.
    pool = _reqs(rng, 12, prompt_len=(3, 4), max_new=(4, 5))
    waves = [pool[:6], pool[6:]]

    # The sensing half (obs/): a probe telemetry row whose first-token
    # histogram is derived from the REAL fleet backlog — saturated
    # one-slot engines queue, queued requests wait, waiting is slow
    # first tokens. Deterministic, but honest: the alert can only
    # resolve because added capacity actually drained the queues.
    probe_hist = Registry().histogram(
        "ft_seconds", buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                               0.1, 0.25, 0.5, 1.0, 2.5))

    def collect() -> dict:
        backlog = sum(r.engine.queue_len for r in sim.replicas if r.alive)
        for _ in range(4):
            v = probe_rng.uniform(0.3, 0.9) if backlog \
                else probe_rng.uniform(0.002, 0.04)
            probe_hist.observe(v)
        return {"hist": {"first_token": probe_hist.merged_snapshot()}}

    probe = TelemetryRegistration(
        "probe", "serve", "127.0.0.1:0", sim.registry_address,
        interval=5.0, pool=sim.pool, collect=collect)
    monitor = FleetMonitor(
        sim.registry_address,
        SloEngine([SLO(name="first_token_p99", kind="latency",
                       objective=0.99, metric="first_token",
                       threshold_s=0.1)],
                  fast_window_s=0.8, slow_window_s=2.4,
                  burn_threshold=10.0, resolve_hold_s=0.3),
        interval=0.15, pool=sim.pool)

    # The acting half (autoscale/): a leader and a hot standby sharing
    # ONE launcher (replica ids stay unique across the failover).
    launcher = SimReplicaLauncher(sim)
    spec = FleetSpec(min_replicas=1, max_replicas=3,
                     cooldown_s=0.5, scale_down_hold_s=1.5)
    scaler_a = Autoscaler(sim.registry_address, spec, launcher,
                          autoscaler_id="as-a", interval=0.5,
                          pool=sim.pool)
    scaler_b = Autoscaler(sim.registry_address, spec, launcher,
                          autoscaler_id="as-b", interval=0.5,
                          pool=sim.pool)
    stop_load = threading.Event()
    load_done: list = []
    load_errors: list = []

    def load_loop() -> None:
        i = 0
        while not stop_load.is_set():
            reqs = waves[i % len(waves)]
            i += 1
            results, errors = sim.routed_load(reqs, concurrency=6,
                                              timeout=60)
            load_done.append((reqs, results))
            load_errors.extend(errors)

    loader = threading.Thread(target=load_loop, daemon=True)
    try:
        monitor.start()
        scaler_a.start()
        assert wait_for(lambda: scaler_a.is_leader, timeout=15), \
            "first autoscaler never took leadership of an empty fleet row"
        scaler_b.start()
        time.sleep(3 * scaler_b.interval)
        assert not scaler_b.is_leader, \
            "standby stole leadership from a live leader"
        for _ in range(5):
            probe.beat_once()  # healthy baseline observations
        mark = sim.mark_faults()

        def feed_until(event_type: str, timeout: float = 30.0) -> None:
            """Beat the probe (real-backlog sensing) until the event
            lands — the rung's clock is the probe's beat."""
            deadline = time.monotonic() + timeout
            while not any(e["seq"] > mark
                          for e in sim.debug_events(event_type)):
                assert time.monotonic() < deadline, \
                    f"timed out waiting for {event_type}"
                probe.beat_once()
                time.sleep(0.05)

        loader.start()
        feed_until(events.SLO_ALERT_FIRED)
        feed_until(events.AUTOSCALE_SCALE_UP)
        # The leader dies mid-incident: crash semantics — its fleet row
        # is abandoned frozen, never deleted. The standby must claim it
        # via lease expiry / beat freeze, ADOPT the raised target, and
        # finish the scale-up.
        scaler_a.stop(deregister=False)
        feed_until(events.AUTOSCALE_TAKEOVER)
        assert wait_for(lambda: scaler_b.is_leader, timeout=10), \
            "standby observed a frozen leader but never claimed the row"
        # Capacity lands: every spawned replica registers ready. Load
        # keeps running — the alert may not resolve while queues back up.
        assert wait_for(
            lambda: sum(1 for r in sim.table.replicas() if r.ready) >= 2,
            timeout=30), "scale-up never produced a second ready replica"
        stop_load.set()
        loader.join(timeout=90)
        assert not loader.is_alive(), "load loop never drained"
        feed_until(events.SLO_ALERT_RESOLVED)
        feed_until(events.AUTOSCALE_SCALE_DOWN, timeout=45.0)
    finally:
        stop_load.set()
        scaler_a.stop(deregister=False)
        scaler_b.stop(deregister=True)
        monitor.stop()
        probe.stop(deregister=True)
        launcher.join()

    assert not load_errors, \
        f"client saw errors across the scaling episode: {load_errors[0]!r}"
    # Waves repeat cyclically: compute each unique request's solo
    # reference once, then hold every occurrence to it.
    expected: dict = {}
    checked = 0
    for reqs, results in load_done:
        for (prompt, n_new, temp, seed), toks in zip(reqs, results):
            if toks is None:
                continue
            key = (tuple(prompt), n_new, temp, seed)
            if key not in expected:
                expected[key] = solo_tokens(prompt, n_new,
                                            temperature=temp, seed=seed,
                                            device=sim.device)
            if toks != expected[key]:
                raise AssertionError(
                    f"routed output diverged from solo generate() for "
                    f"prompt={prompt} temp={temp} seed={seed}: "
                    f"{toks} != {expected[key]}")
            checked += 1
    ups = [e for e in sim.debug_events(events.AUTOSCALE_SCALE_UP)
           if e["seq"] > mark]
    takeovers = [e for e in sim.debug_events(events.AUTOSCALE_TAKEOVER)
                 if e["seq"] > mark]
    assert takeovers and takeovers[0]["attrs"]["autoscaler"] == "as-b", \
        f"takeover not by the standby: {takeovers}"
    # The standby inherited the incident's raised target, not min.
    assert takeovers[0]["attrs"]["adopted_target"] >= 2, \
        f"takeover drained the inherited capacity: {takeovers[0]}"
    return {"waves": len(load_done),
            "requests": sum(len(r) for r, _ in load_done),
            "byte_identical": checked,
            "scale_ups": len(ups),
            "takeover_by": takeovers[0]["attrs"]["autoscaler"]}


def _run_shard_member_kill(sim: ClusterSim, rng: random.Random) -> dict:
    """SIGKILL one non-rank-0 member of the 2-way sharded replica r0
    mid-stream: its ``serve/r0.member.1`` lease outlives the corpse, and
    the LAPSE (not the kill) flips the whole replica not-ready — a mesh
    missing a member cannot decode — so the router rotates every
    subsequent pick onto the solo survivor r1 with zero client-visible
    errors and byte-identical outputs. Heal is drain + re-prestage: the
    rebooted member re-maps its slice of the SAME content-addressed
    weights volume (an O(1) stage-cache HIT, zero source re-reads),
    restores only its 1/N of the split leaves, re-takes its lease, and
    the replica returns to the table."""
    from oim_tpu_torch.serve import weights as W

    sim.warm()
    r0, r1 = sim.replicas
    assert r0.engine.shard == 2, "rung misconfigured: r0 not sharded"
    assert r0.engine.stats()["ready"], "sharded replica booted not-ready"
    # The fleet's original weights prestage (what every booting member
    # maps before slicing out its rank's tree).
    params, _ = sim_model(sim.device)
    path = sim.tmpfile(W.pack_params(params))
    feeder = sim.feeder()
    W.publish_weights(feeder, "shard-weights", path)
    reqs = _reqs(rng, 5)
    results, errors = sim.routed_load(reqs[:2])
    assert not errors, f"warm load failed: {errors[0]!r}"
    mark = sim.mark_faults()
    r0.kill_member(1)
    assert wait_for(lambda: not r0.engine.stats()["ready"], timeout=10), \
        "member lease lapse never flipped the replica not-ready"
    assert wait_for(
        lambda: all(r.replica_id != "r0" for r in sim.table.replicas()),
        timeout=10), "not-ready sharded replica never left the table"
    done_r0 = r0.completed()
    results, errors = sim.routed_load(reqs)
    assert not errors, \
        f"client saw errors across the member kill: {errors[0]!r}"
    checked = sim.assert_byte_identity(reqs, results)
    assert r0.completed() == done_r0, \
        "router sent traffic to the degraded sharded replica"
    assert r1.completed() >= len(reqs), \
        "survivor never absorbed the rotated stream"
    # Heal: the member's re-prestage of identical content must be the
    # O(1) cache path — proven by the hit counter, not wall clock —
    # and its restore stages ONLY its slice (split leaves cut 1/N).
    hits_before = M.STAGE_CACHE_HITS.value
    feeder.unpublish("shard-weights")
    W.publish_weights(feeder, "shard-weights", path)
    assert M.STAGE_CACHE_HITS.value == hits_before + 1, \
        "member re-prestage was not a stage-cache hit"
    W.restore_weights(feeder, "shard-weights", shard=2, rank=1)
    staged = W.LAST_RESTORE["bytes_staged"]
    assert 0 < staged < W.LAST_RESTORE["total_bytes"], \
        f"member restore staged {staged} of {W.LAST_RESTORE} — not a slice"
    r0.restart_member(1)
    assert wait_for(lambda: r0.engine.stats()["ready"], timeout=10), \
        "restarted member never healed readiness"
    assert wait_for(
        lambda: any(r.replica_id == "r0" for r in sim.table.replicas()),
        timeout=10), "healed sharded replica never rejoined the table"
    post = _reqs(rng, 2)
    results, errors = sim.routed_load(post)
    assert not errors, f"post-heal load failed: {errors[0]!r}"
    checked += sim.assert_byte_identity(post, results)
    sim.wait_heal(
        [events.SHARD_MEMBER_LOST, events.SHARD_MEMBER_HEALED], mark)
    return {"requests": len(reqs) + len(post), "byte_identical": checked,
            "restage_cache_hit": True, "member_slice_bytes": staged,
            "full_weights_bytes": W.LAST_RESTORE["total_bytes"]}


@dataclasses.dataclass(frozen=True)
class Rung:
    """One scripted fault schedule: its sim shape, its seeded driver,
    and the heal-event signature that DEFINES convergence."""

    name: str
    expect: tuple[str, ...]
    run: Callable[[ClusterSim, random.Random], dict]
    sim_kwargs: dict
    slow: bool = False


RUNGS: tuple[Rung, ...] = (
    Rung("replica_kill",
         (events.ROUTER_MARK_FAILED, events.ROUTER_RETRY),
         _run_replica_kill, dict(replicas=2)),
    Rung("channel_blackhole",
         (events.ROUTER_MARK_FAILED, events.ROUTER_RETRY),
         _run_channel_blackhole, dict(replicas=2)),
    Rung("pool_exhaustion",
         (events.PAGE_POOL_EXHAUSTED,),
         _run_pool_exhaustion,
         dict(replicas=1, engine_kwargs=[dict(
             max_batch=4, max_seq=64, queue_depth=32,
             kv_pool_tokens=128, prefix_cache_bytes=0)])),
    Rung("registry_promotion",
         (events.REGISTRY_PROMOTION,),
         _run_registry_promotion,
         dict(replicas=2, registry_pair=True, primary_lease_s=0.5)),
    Rung("quorum_leader_kill",
         (events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION),
         _run_quorum_leader_kill,
         dict(replicas=2, registry_quorum=3)),
    Rung("quorum_partition",
         (events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION,
          events.REGISTRY_STEPDOWN),
         _run_quorum_partition,
         dict(replicas=0, registry_quorum=3)),
    Rung("registry_rolling_restart",
         (events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION),
         _run_registry_rolling_restart,
         dict(replicas=0, registry_quorum=3)),
    Rung("registry_rolling_restart_lite",
         (events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION),
         _run_rolling_restart_lite,
         dict(replicas=0, registry_quorum=3, lite_replicas=100,
              lite_interval_s=2.0, lite_volume_keys=2)),
    Rung("feeder_failover",
         (events.FEEDER_FAILOVER, events.VOLUME_HEALED),
         _run_feeder_failover, dict(replicas=0, controllers=2)),
    Rung("draft_collapse",
         (events.SPEC_FALLBACK,),
         _run_draft_collapse,
         dict(replicas=1, engine_kwargs=[dict(
             _draft=True, spec_tokens=4, spec_accept_floor=0.95,
             spec_window_rounds=4, spec_reprobe_rounds=100_000,
             max_batch=2, max_seq=64, queue_depth=16)])),
    Rung("kv_peer_fetch",
         (events.KV_PEER_FETCH, events.KV_FETCH_FALLBACK),
         _run_kv_peer_fetch,
         dict(replicas=2, controllers=1,
              engine_kwargs=[dict(kv_host_bytes=1 << 20),
                             dict(kv_host_bytes=1 << 20)])),
    Rung("prefill_replica_kill",
         (events.KV_PEER_FETCH, events.ROUTER_MARK_FAILED,
          events.KV_FETCH_FALLBACK),
         _run_prefill_replica_kill,
         dict(replicas=2, controllers=1,
              engine_kwargs=[dict(role="prefill", prefill_chunk=8),
                             dict(role="decode")])),
    Rung("shard_member_kill",
         (events.SHARD_MEMBER_LOST, events.SHARD_MEMBER_HEALED),
         _run_shard_member_kill,
         dict(replicas=2, controllers=1,
              engine_kwargs=[dict(shard=2), dict()])),
    Rung("autoscale",
         (events.SLO_ALERT_FIRED, events.AUTOSCALE_SCALE_UP,
          events.AUTOSCALE_TAKEOVER, events.SLO_ALERT_RESOLVED,
          events.AUTOSCALE_SCALE_DOWN),
         _run_autoscale, dict(replicas=1, max_batch=1)),
    Rung("compound",
         (events.REGISTRY_PROMOTION, events.REPLICA_DRAIN,
          events.ROUTER_MARK_FAILED, events.ROUTER_RETRY),
         _run_compound,
         dict(replicas=3, registry_pair=True, primary_lease_s=0.5),
         slow=True),
)

# The trimmed tier-1 set: no replication pair, no spec compile — the
# fast rungs that exercise the serving tier's own heal paths in
# seconds (including the fleet-KV-tier fetch/fallback rung), plus the
# serve-free fast variants of the quorum rungs (partition and rolling
# restart over 3 registries only; the full leader-kill-under-load rung
# runs in `make chaos`).
SMOKE_RUNGS = ("replica_kill", "channel_blackhole", "pool_exhaustion",
               "kv_peer_fetch", "prefill_replica_kill",
               "shard_member_kill", "quorum_partition",
               "registry_rolling_restart")


# The rungs that drive the engine alone: they run over an EngineSim
# (no grpcio, no protobuf) through run_engine_rungs, on the card too.
ENGINE_RUNGS = ("pool_exhaustion", "draft_collapse")


def _select(names, include_slow: bool) -> list[Rung]:
    if names is not None:
        unknown = set(names) - {r.name for r in RUNGS}
        if unknown:
            raise ValueError(f"unknown rung name(s) {sorted(unknown)}; "
                             f"rungs: {[r.name for r in RUNGS]}")
    selected = [r for r in RUNGS
                if (names is None or r.name in names)
                and (include_slow or not r.slow)]
    if not selected:
        # A gate that selects nothing must fail loudly, not pass empty.
        raise ValueError(
            f"no rungs selected (names={names}, "
            f"include_slow={include_slow})")
    return selected


def _run(selected: list[Rung], seed: int, sim_class, device) -> dict:
    rng_master = random.Random(seed)
    backoff.use_rng(rng_master)  # every backoff draw rides the seed
    report: dict = {"seed": seed, "rungs": [], "event_signature": []}
    try:
        for rung in selected:
            rng = random.Random(f"{seed}:{rung.name}")
            t0 = time.monotonic()
            with sim_class(**rung.sim_kwargs, device=device) as sim:
                details = rung.run(sim, rng)
                # Scoped to the rung's own fault mark: pre-fault warm or
                # baseline traffic must not pollute the declared
                # first-occurrence heal order.
                healed = sim.heal_signature(rung.expect, sim.fault_mark)
                if healed != list(rung.expect):
                    raise AssertionError(
                        f"rung {rung.name!r} heal signature diverged: "
                        f"expected {list(rung.expect)}, observed {healed}")
                census = sim.leak_census()
            report["rungs"].append({
                "name": rung.name,
                "healed": healed,
                "wall_s": round(time.monotonic() - t0, 3),
                "census": census,
                "details": details,
            })
            report["event_signature"].append([rung.name, *healed])
    finally:
        backoff.use_rng(None)
    return report


def run_ladder(seed: int = DEFAULT_SEED, include_slow: bool = True,
               names=None, device="cuda") -> dict:
    """Run the ladder. Each rung builds a fresh ``ClusterSim`` on
    ``device`` (isolation: a rung's corpses never haunt the next), runs
    its scripted schedule against its own seeded RNG, and must converge:
    observed heal signature == declared ``expect`` (same order), plus the
    rung's own zero-error / byte-identity assertions and the zero-leak
    census. Returns the per-rung report; raises AssertionError on any
    divergence."""
    return _run(_select(names, include_slow), seed, ClusterSim, device)


def run_engine_rungs(seed: int = DEFAULT_SEED, names=ENGINE_RUNGS,
                     device="cuda") -> dict:
    """The ladder's engine rungs (``ENGINE_RUNGS``) over an ``EngineSim``
    on ``device``: the same drivers, seeds, signature checks, census and
    report as ``run_ladder``, without the gRPC surface. Refuses any other
    rung by name."""
    names = list(names)
    off = sorted(set(names) - set(ENGINE_RUNGS))
    if off:
        raise ValueError(f"rung(s) {off} need the gRPC cluster (run_ladder); "
                         f"the engine rungs: {list(ENGINE_RUNGS)}")
    return _run(_select(names, True), seed, EngineSim, device)


def fault_overhead(rounds: int = 6, n_requests: int = 24,
                   max_new: int = 12, device="cuda", model=None) -> dict:
    """The no-op-when-unarmed guard for the serving tier's fault points:
    serve throughput with the REAL (unarmed) ``fire`` vs a stubbed no-op,
    paired per round with alternating order, median of the paired ratios
    (pairing cancels box drift, the median cancels one disturbed round).
    An unarmed ``fire`` is one dict lookup, so this ratio must sit at
    ~1.0. ``model`` is a ``(params, cfg)`` pair on ``device`` (default:
    the sim's tiny model there)."""
    from oim_tpu_torch.common import faultinject
    from oim_tpu_torch.serve import ServeEngine

    params, cfg = model if model is not None else sim_model(device)
    engine = ServeEngine(params, cfg, max_batch=4, max_seq=64,
                         queue_depth=n_requests, device=device)
    rng = np.random.RandomState(11)
    reqs = [rng.randint(1, cfg.vocab, size=rng.randint(2, 8)).tolist()
            for _ in range(n_requests)]
    real_fire = faultinject.fire

    def noop_fire(point, **ctx):
        return None

    walls: dict[str, list[float]] = {"real": [], "noop": []}
    try:
        engine.submit([1, 2, 3], max_new=2).result(timeout=300)  # warm

        def one_round() -> float:
            t0 = time.monotonic()
            handles = [engine.submit(p, max_new=max_new, temperature=0.0,
                                     seed=i)
                       for i, p in enumerate(reqs)]
            for h in handles:
                h.result(timeout=300)
            return time.monotonic() - t0

        for i in range(rounds):
            order = ("real", "noop") if i % 2 == 0 else ("noop", "real")
            for mode in order:
                faultinject.fire = (real_fire if mode == "real"
                                    else noop_fire)
                walls[mode].append(one_round())
    finally:
        faultinject.fire = real_fire
        engine.stop(drain=False, timeout=30)
    ratios = sorted(noop / real
                    for real, noop in zip(walls["real"], walls["noop"]))
    median = ratios[len(ratios) // 2]
    return {
        # noop/real throughput ratio: 1.0 = the unarmed fire is free.
        "fault_overhead_ratio": round(median, 4),
        "fault_overhead_pair_spread": [round(ratios[0], 4),
                                       round(ratios[-1], 4)],
        "fault_overhead_rounds": rounds,
    }
