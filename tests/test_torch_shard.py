"""The port's tensor-parallel serving (oim_tpu_torch.serve.shard, the
``axis`` of models/generate.py and ``ServeEngine(shard=...)``) held
against the JAX package's on the CPU, on the serving sims' tiny model
(``oim_tpu.chaos.sim.model()``: llama.tiny, vocab 64, dim 32, 2 layers,
f32), its weights carried across with ``llama.from_numpy``.

* The leaf and pool splits and ``member_weight_bytes`` equal JAX's, the
  member pieces equal the shards ``NamedSharding(tp_mesh(2), leaf_spec)``
  places on each fake device; the trainer's rank pieces equal the
  ``TP_SP_RULES`` shards.
* ``prefill_into_pages``, ``decode_step`` and ``verify_step`` run by two
  members (``devices=["cpu", "cpu"]``) give JAX's ``wrap_forward``
  logits at shard 2 within 2e-5 (f32; tests/test_torch_generate.py's
  tolerance), and the members' pools JAX's pool shards.
* The engine's greedy streams are byte-identical across port shard 1,
  port shard 2, JAX shard 2 and solo; sampled streams are shard-invariant
  within the port (torch's generators are not JAX's threefry chains).
* tests/test_shard_smoke.py's engine tests, ported: the spec path at
  shard 1 and 2, the member-memory gate, and the member-watch readiness
  with its gauges and events.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from oim_tpu.chaos.sim import model as jmodel
from oim_tpu.chaos.sim import solo_tokens
from oim_tpu.models import generate as jgen
from oim_tpu.parallel import sharding as jsharding
from oim_tpu.serve import ServeEngine as JServeEngine
from oim_tpu.serve import shard as jshard
from oim_tpu_torch.common import events, metrics as M
from oim_tpu_torch.models import generate as tgen
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.parallel import sharding as tsharding
from oim_tpu_torch.serve import ServeEngine
from oim_tpu_torch.serve import shard as tshard

torch.set_num_threads(2)

F32 = dict(atol=2e-5, rtol=1e-5)
CPU2 = ["cpu", "cpu"]
PAGE = 4
# (prompt, max_new, temperature, seed): greedy ones pinned to solo too.
REQS = [([3, 1, 4, 1], 6, 0.0, 0), ([2, 7, 1], 5, 0.7, 3), ([5, 9, 2, 6, 5, 3, 5], 8, 0.0, 0),
        ([8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6, 4, 3, 3, 8, 3], 7, 0.9, 11)]


@pytest.fixture(scope="module")
def sim():
    jp, jcfg = jmodel()
    host = jax.tree.map(np.asarray, jp)
    tcfg = tllama.tiny(vocab=64, dim=32, n_layers=2)
    return jp, jcfg, host, tllama.from_numpy(host, device="cpu"), tcfg


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _device_shards(arr, devices):
    """The piece of a placed JAX array on each of ``devices``."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in devices]


# ---------------------------------------------------------- the splits ----


def test_leaf_and_pool_specs_and_weight_bytes_match_jax(sim):
    _, _, host, tparams, _ = sim
    assert tshard.COL == jshard.COL and tshard.ROW == jshard.ROW
    for name in ("wq", "wk", "wv", "w_gate", "w_up", "wo", "w_down", "embed", "lm_head",
                 "attn_norm", "mlp_norm", "final_norm"):
        assert tshard.leaf_spec(name) == tuple(jshard.leaf_spec(name)), name
    assert {k: tuple(v) for k, v in jshard.pool_specs().items()} == tshard.pool_specs()
    for n in (1, 2, 4):
        want = jshard.member_weight_bytes(host, n)
        assert tshard.member_weight_bytes(host, n) == want
        assert tshard.member_weight_bytes(tparams, n) == want


def test_member_pieces_equal_jax_device_shards(sim):
    jp, jcfg, host, tparams, _ = sim
    mesh = jshard.tp_mesh(2)
    devices = list(mesh.devices.flat)
    placed = jax.device_put(jp, jax.tree_util.tree_map_with_path(
        lambda p, _: NamedSharding(mesh, jshard.leaf_spec(p[-1].key)), jp))
    for rank in range(2):
        mine = dict(_leaves(tshard.member_params(tparams, 2, rank, "cpu")))
        for name, arr in _leaves(placed):
            piece = mine[name]
            assert piece.is_contiguous()
            np.testing.assert_array_equal(piece.numpy(), _device_shards(arr, devices)[rank],
                                          err_msg=name)
    pool = jgen.init_page_pool(jcfg, 5, PAGE)
    pool = jax.tree.map(lambda x: x + jax.random.normal(jax.random.PRNGKey(3), x.shape), pool)
    placed = {k: jax.device_put(v, NamedSharding(mesh, jshard.pool_specs()[k]))
              for k, v in pool.items()}
    for rank in range(2):
        for k, spec in tshard.pool_specs().items():
            np.testing.assert_array_equal(
                tshard.member_slice(np.asarray(pool[k]), spec, 2, rank),
                _device_shards(placed[k], devices)[rank])
    with pytest.raises(ValueError, match="does not split"):
        tshard.member_params(tparams, 3, 0)
    with pytest.raises(ValueError, match="outside"):
        tshard.member_params(tparams, 2, 2)


def test_rank_pieces_equal_jax_tp_sp_shards(sim):
    """The trainer's pieces (``sharding.rank_params``, per rank of a
    fsdp=2,model=2 mesh) equal the shards JAX places under TP_SP_RULES."""
    jp, jcfg, host, tparams, tcfg = sim
    axes = [("data", 1), ("fsdp", 2), ("seq", 1), ("model", 2)]
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(1, 2, 1, 2),
                              [a for a, _ in axes])
    from oim_tpu.models import llama as jllama

    logical = jllama.param_logical_axes(jcfg)
    placed = jax.device_put(jp, jax.tree.map(
        lambda ax: jsharding.logical_sharding(jmesh, jsharding.TP_SP_RULES, ax), logical,
        is_leaf=lambda x: isinstance(x, tuple)))
    devices = list(jmesh.devices.flat)
    for rank in range(4):
        mine = dict(_leaves(tsharding.rank_params(
            tparams, tllama.param_logical_axes(tcfg), tsharding.TP_SP_RULES, axes, rank)))
        for name, arr in _leaves(placed):
            np.testing.assert_array_equal(mine[name].numpy(), _device_shards(arr, devices)[rank],
                                          err_msg=f"{name} rank {rank}")


def test_budget_messages_match_jax(sim):
    _, _, host, tparams, _ = sim
    full = jshard.member_weight_bytes(host, 1)
    for shard, pool, budget in ((1, 4096, full), (2, 4096, full), (2, 1 << 20, full // 2)):
        try:
            want = jshard.check_member_budget(host, shard, pool, budget)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tshard.check_member_budget(tparams, shard, pool, budget)
            assert str(got.value) == str(e)
        else:
            assert tshard.check_member_budget(tparams, shard, pool, budget) == want


def test_member_group_sums_in_member_order_and_raises_a_members_error():
    group = tshard.MemberGroup(["cpu"] * 3)
    xs = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 0.5]), torch.tensor([1.0, 0.25])]
    outs = group.run(lambda k: group.allreduce(xs[k]))
    want = (xs[0] + xs[1]) + xs[2]
    for out in outs:
        assert torch.equal(out, want)

    def bad(k):
        if k == 1:
            raise KeyError("member 1")
        return group.allreduce(xs[k])

    with pytest.raises(KeyError, match="member 1"):
        group.run(bad)
    assert group.run(lambda k: group.allreduce(xs[k]))[2].tolist() == want.tolist()
    with pytest.raises(RuntimeError, match="outside a member thread"):
        group.allreduce(xs[0])
    assert tshard.time_allreduce(group) > 0
    with pytest.raises(ValueError, match="needs 2 member devices"):
        tshard.member_devices(2, ["cpu"])


def test_member_group_rendezvous_under_a_short_switch_interval():
    """More members than cores, many rounds back to back, the interpreter
    switching threads every microsecond: every member of every round gets
    that round's sum (a part read after its slot was reused would not)."""
    import os
    import sys
    import threading

    n, rounds = (os.cpu_count() or 2) + 4, 200
    group = tshard.MemberGroup(["cpu"] * n)
    want = [sum(float(r * n + k) for k in range(n)) for r in range(rounds)]
    out: dict = {}

    def member(k):
        return [float(group.allreduce(torch.tensor([float(r * n + k)], dtype=torch.float64)))
                for r in range(rounds)]

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=lambda: out.update(got=group.run(member)))
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not worker.is_alive()
    assert out["got"] == [want] * n


# ------------------------------------------------------ sharded steps ----


def test_sharded_steps_match_jax_wrap_forward(sim):
    """Two prefills (a full prompt and a prefix hit's tail), a decode step
    with an idle row and a verify past the table, through the port's
    members and JAX's shard_map at shard 2; logits and the members' pools
    against JAX's."""
    jp, jcfg, host, tparams, tcfg = sim
    lj, lt = jgen.shard_config(jcfg, 2), tgen.shard_config(tcfg, 2)
    group = tshard.member_group(tshard.member_devices(2, CPU2))
    members = [tshard.member_params(tparams, 2, k, "cpu") for k in range(2)]
    tpools = [tgen.init_page_pool(lt, 9, PAGE, device="cpu") for _ in range(2)]
    jpool = jgen.init_page_pool(jcfg, 9, PAGE)
    jpre = jax.jit(jshard.wrap_forward(2, lambda p, t, n, c, tb, st: jgen.prefill_into_pages(
        p, t, n, c, tb, st, lj, PAGE, axis="tp"), cache_arg=2))
    jdec = jax.jit(jshard.wrap_forward(2, lambda p, t, c, tb, ps: jgen.decode_step(
        p, t, c, tb, ps, lj, PAGE, axis="tp"), cache_arg=1))
    jver = jax.jit(jshard.wrap_forward(2, lambda p, t, c, tb, ps: jgen.verify_step(
        p, t, c, tb, ps, lj, PAGE, axis="tp"), cache_arg=1))
    tpre = tshard.wrap_forward(group, lambda p, t, n, c, tb, st: tgen.prefill_into_pages(
        p, t, n, c, tb, st, lt, PAGE, axis=group), cache_arg=2)
    tdec = tshard.wrap_forward(group, lambda p, t, c, tb, ps: tgen.decode_step(
        p, t, c, tb, ps, lt, PAGE, axis=group), cache_arg=1)
    tver = tshard.wrap_forward(group, lambda p, t, c, tb, ps: tgen.verify_step(
        p, t, c, tb, ps, lt, PAGE, axis=group), cache_arg=1)
    rng = np.random.RandomState(4)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for row, (n, start) in enumerate(((9, 0), (3, 4))):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = rng.randint(0, 64, n)
        jl, jpool = jpre(jp, toks, n, jpool, tables[row], start)
        tl, tpools = tpre(members, torch.from_numpy(toks).long(), n, tpools,
                          torch.from_numpy(tables[row]).long(), start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    cand = rng.randint(0, 64, (2, 4)).astype(np.int32)
    pos = np.array([9, 7], np.int32)
    idle = np.array([[1, 2, 3, 4], [0, 0, 0, 0]], np.int32)
    jl, jpool = jdec(jp, cand[:, 0], jpool, idle, pos)
    tl, tpools = tdec(members, torch.from_numpy(cand[:, 0]).long(), tpools,
                      torch.from_numpy(idle).long(), torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl[:1].numpy(), np.asarray(jl)[:1], **F32)
    pos = np.array([10, 14], np.int32)  # row 1 runs past its 16-position table
    jl, jpool = jver(jp, cand, jpool, tables, pos)
    tl, tpools = tver(members, torch.from_numpy(cand).long(), tpools,
                      torch.from_numpy(tables).long(), torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], **F32)
    np.testing.assert_allclose(tl[1, :2].numpy(), np.asarray(jl)[1, :2], **F32)
    mesh = jshard.tp_mesh(2)
    devices = list(mesh.devices.flat)
    for k in ("k", "v"):
        want = _device_shards(jax.device_put(jpool[k], NamedSharding(
            mesh, jshard.pool_specs()[k])), devices)
        for rank in range(2):  # scratch page 0 is garbage by design
            np.testing.assert_allclose(tpools[rank][k][:, 1:].numpy(), want[rank][:, 1:],
                                       **F32)


def test_tensor_parallel_decode_of_moe_raises_jax_error(sim):
    *_, tcfg = sim
    moe = tllama.tiny(vocab=64, dim=32, n_layers=2, n_experts=4)
    for fn in (lambda: tgen.shard_config(moe, 2),
               lambda: tgen.decode_step({}, torch.tensor([1]), {}, torch.ones(1, 2),
                                        torch.tensor([0]), moe, PAGE, axis=object())):
        with pytest.raises(ValueError, match="does not support MoE"):
            fn()


# ------------------------------------------------------------ engines ----


def _run(engine, reqs=REQS):
    try:
        outs = [engine.submit(p, max_new=n, temperature=t, seed=s).result(timeout=120)
                for p, n, t, s in reqs]
    finally:
        engine.stop(drain=True, timeout=60)
    return outs


def _engine(tparams, tcfg, shard, **kw):
    extra = {"devices": CPU2} if shard == 2 else {}
    return ServeEngine(tparams, tcfg, max_batch=2, max_seq=64, queue_depth=8, shard=shard,
                       device="cpu", **extra, **kw)


def _assert_shard_invariant(sim, **build):
    jp, jcfg, host, tparams, tcfg = sim
    outs = {}
    for shard in (1, 2):
        eng = _engine(tparams, tcfg, shard, **build)
        outs[shard] = _run(eng)
        assert eng.error is None, eng.error
        eng.evict_prefix_store()
        assert eng.pool_stats()["used_pages"] == 0
    assert outs[1] == outs[2], f"shard changed bytes ({build})"
    for (p, n, t, _), out in zip(REQS, outs[2]):
        if t == 0:
            assert out == solo_tokens(p, n)
    return outs


def test_engine_byte_identity_port_shard_1_2_jax_shard_2_and_solo(sim):
    jp, jcfg, *_ = sim
    outs = _assert_shard_invariant(sim)
    jeng = JServeEngine(jp, jcfg, max_batch=2, max_seq=64, queue_depth=8, shard=2)
    jouts = _run(jeng)
    assert jeng.stats()["shard_total"] == 2
    for (p, n, t, _), got, want in zip(REQS, outs[2], jouts):
        if t == 0:
            assert got == want


def test_spec_engine_byte_identity_shard_1_vs_2(sim):
    _, _, _, tparams, tcfg = sim
    outs = _assert_shard_invariant(sim, draft_params=tparams, draft_cfg=tcfg, spec_tokens=2)
    assert all(len(o) == n for o, (_, n, _, _) in zip(outs[2], REQS))


def test_sharded_engine_host_tier_round_trip_is_exact(sim):
    """A prefix page demoted from the members' pools to the host tier and
    promoted back repeats the request's stream at shard 2."""
    _, _, _, tparams, tcfg = sim
    eng = _engine(tparams, tcfg, 2, prefix_block=4, kv_host_bytes=1 << 20)
    prompt = list(range(1, 14))
    try:
        first = eng.submit(prompt, max_new=5).result(timeout=120)
        assert eng.evict_prefix_store() > 0
        h = eng.submit(prompt, max_new=5)
        assert h.result(timeout=120) == first
        assert eng.host_stats()["promotions"] >= 3 and h.stats["prefix_tokens"] == 12
    finally:
        eng.stop(drain=True, timeout=60)
    assert first == solo_tokens(prompt, 5)


def test_member_hbm_budget_gate(sim):
    _, _, host, tparams, tcfg = sim
    budget = tshard.member_weight_bytes(tparams, 1)  # weights fit, weights + pool don't
    with pytest.raises(ValueError, match="shard wider"):
        _engine(tparams, tcfg, 1, member_hbm_budget=budget)
    eng = _engine(tparams, tcfg, 2, member_hbm_budget=budget)
    held = sum(t.numel() * t.element_size() for p in eng.params for _, t in _leaves(p))
    eng.stop(drain=False, timeout=30)
    assert held == 2 * tshard.member_weight_bytes(tparams, 2)
    with pytest.raises(ValueError, match="must divide n_heads"):
        _engine(tparams, tcfg, 3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        ServeEngine(tparams, tcfg, max_batch=2, max_seq=64, shard=2, device="cpu")


def test_member_watch_flips_readiness_gauges_and_events(sim):
    _, _, _, tparams, tcfg = sim
    events.configure(capacity=256)
    eng = _engine(tparams, tcfg, 2)
    counts = {"ready": 2, "stale": 0, "total": 2}
    eng.set_member_watch(lambda: dict(counts))
    try:
        s = eng.stats()
        assert s["ready"] and s["shard_ready"] == 2 and s["shard_total"] == 2
        counts.update(ready=1, stale=1)
        s = eng.stats()
        assert not s["ready"], "stale member left the replica ready"
        assert s["shard_ready"] == 1
        assert M.SERVE_SHARD_MEMBERS.labels(state="ready").value == 1
        assert M.SERVE_SHARD_MEMBERS.labels(state="stale").value == 1
        counts.update(ready=2, stale=0)
        assert eng.stats()["ready"], "healed members never restored ready"
        eng.stats()  # a steady state emits nothing more
        types = [e.type for e in events.recorder().events()]
        assert types.count(events.SHARD_MEMBER_LOST) == 1
        assert types.count(events.SHARD_MEMBER_HEALED) == 1
    finally:
        eng.stop(drain=False, timeout=30)
    assert "shard_total" not in _engine(tparams, tcfg, 1).stats()


def test_allreduce_observed_once_per_target_dispatch(sim):
    _, _, _, tparams, tcfg = sim
    eng = _engine(tparams, tcfg, 2)
    start = M.SERVE_ICI_ALLREDUCE.count
    _run(eng, REQS[:2])
    assert M.SERVE_ICI_ALLREDUCE.count - start == eng.stats()["target_steps"] > 0
