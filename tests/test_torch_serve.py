"""The port's serving slice (oim_tpu_torch.serve) held against the JAX
package's, on the CPU at llama.tiny (vocab 64, dim 32, 2 layers, the
size tests/test_serve.py uses), JAX weights carried across with from_numpy.

* The jax-free copies (prefixhash, PagePool, PrefixStore, HostTier,
  AcceptanceValve) run the same scripted operation sequences as their
  originals and must return the same values and raise the same errors.
* ``accept_tokens``: greedy (out, n_emit) equal to the JAX function's;
  sampled output frequencies within a chi-square bound of the target.
* The engine: the invariants of tests/test_serve.py, test_paged_pool.py,
  test_prefix_cache.py, test_kvtier.py and test_spec.py. Greedy streams
  equal JAX ``generate()`` token for token; sampled streams equal the
  port's own solo ``generate()`` (its sampling cannot reproduce JAX's
  threefry chains) and so do not depend on their batch-mates.
"""

import ast
import dataclasses
import functools
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.common import prefixhash as jprefixhash
from oim_tpu.models import generate as jgen
from oim_tpu.models import llama as jllama
from oim_tpu.serve import kvtier as jkvtier
from oim_tpu.serve import pagepool as jpagepool
from oim_tpu.serve import prefixcache as jprefixcache
from oim_tpu.serve import spec as jspec
from oim_tpu_torch.common import prefixhash as tprefixhash
from oim_tpu_torch.models import generate as tgen
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.serve import Draining, QueueFull, ServeEngine
from oim_tpu_torch.serve import kvtier as tkvtier
from oim_tpu_torch.serve import pagepool as tpagepool
from oim_tpu_torch.serve import prefixcache as tprefixcache
from oim_tpu_torch.serve import spec as tspec

torch.set_num_threads(2)


def wait_for(predicate, timeout=30.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _tiny():
    return (jllama.tiny(vocab=64, dim=32, n_layers=2),
            tllama.tiny(vocab=64, dim=32, n_layers=2))


def _carry(jp):
    return tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, JAX cfg, port cfg): one set of weights."""
    jcfg, tcfg = _tiny()
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    return jp, _carry(jp), jcfg, tcfg


@pytest.fixture(scope="module")
def draft_model():
    """A DIFFERENT draft (independent init): its proposals disagree."""
    jcfg, tcfg = _tiny()
    return _carry(jllama.init(jax.random.PRNGKey(7), jcfg)), tcfg


@functools.lru_cache(maxsize=None)
def _jax_solo(prompt: tuple, n_new: int, max_seq: int):
    jcfg, _ = _tiny()
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    out = jgen.generate(jp, jnp.asarray([prompt], jnp.int32), n_new, jcfg, max_seq=max_seq)
    return np.asarray(out)[0, len(prompt):].tolist()


def solo(model, prompt, n_new, temperature=0.0, seed=0, max_seq=64):
    """The byte-identity reference: JAX generate() for a greedy request
    (pinned in tests/test_torch_generate.py to equal the port's), the
    port's own solo generate() with the request's generator for a sampled
    one."""
    if temperature == 0:
        return _jax_solo(tuple(prompt), n_new, max_seq)
    _, tp, _, tcfg = model
    out = tgen.generate(tp, torch.tensor([prompt]), n_new, tcfg,
                        temperature=temperature,
                        rng=torch.Generator().manual_seed(seed), max_seq=max_seq)
    return out[0, len(prompt):].tolist()


def engine(model, **kw):
    _, tp, _, tcfg = model
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("queue_depth", 16)
    return ServeEngine(tp, tcfg, device="cpu", **kw)


# ------------------------------------------------- the jax-free copies ----


@pytest.mark.parametrize("tokens,block", [
    (list(range(40)), 16), ([5] * 33, 4), ([], 4), ([-3, 2 ** 40, 7, 0, 1], 2),
    (np.random.RandomState(0).randint(0, 128256, 300).tolist(), 16)])
def test_prefixhash_strings_identical(tokens, block):
    assert tprefixhash.chain_hashes(tokens, block) == jprefixhash.chain_hashes(tokens, block)
    assert tprefixhash.usable_hashes(tokens, block) == jprefixhash.usable_hashes(tokens, block)
    assert tprefixhash.HASH_CHARS == jprefixhash.HASH_CHARS


def _replay(obj_a, obj_b, script):
    """Run (method, args) steps on both objects; every result (or the
    error type raised) must agree."""
    for step, (name, *args) in enumerate(script):
        outs = []
        for obj in (obj_a, obj_b):
            try:
                attr = getattr(obj, name)
                outs.append(("ok", attr(*args) if callable(attr) else attr))
            except Exception as e:  # noqa: BLE001 - the error type is compared
                outs.append(("raise", type(e).__name__))
        assert outs[0] == outs[1], (step, name, args, outs)


POOL_SCRIPTS = {
    "alloc-ref-unref": [("alloc", 3), ("ref", [1, 2]), ("stats",), ("unref", [1, 2, 3]),
                        ("refcount", 1), ("free_pages",), ("alloc", 2), ("stats",)],
    "exhaustion": [("alloc", 4), ("alloc", 1), ("unref", [2]), ("alloc", 1),
                   ("used_pages",), ("stats",), ("alloc", -1)],
    "errors": [("unref", [1]), ("ref", [2]), ("alloc", 1), ("unref", [1]),
               ("unref", [1]), ("stats",)],
}


@pytest.mark.parametrize("script", POOL_SCRIPTS.values(), ids=POOL_SCRIPTS.keys())
def test_pagepool_matches_jax(script):
    _replay(jpagepool.PagePool(4, 8, page_bytes=64, track_metrics=False),
            tpagepool.PagePool(4, 8, page_bytes=64), script)
    for ctor in (lambda *a: jpagepool.PagePool(*a, track_metrics=False),
                 tpagepool.PagePool):
        with pytest.raises(ValueError):
            ctor(0, 4)


STORE_SCRIPTS = {
    "retain-match-gather": [
        ("retain", ["a", "b", "c"], [1, 2, 3]), ("match", ["a", "b", "x"]),
        ("gather", ["a", "b"]), ("gather", ["a", "z"]), ("hot", 5), ("stats",),
        ("page_of", "c"), ("__len__",), ("__contains__", "b")],
    "lru-and-release": [
        ("retain", ["a", "b"], [1, 2]), ("retain", ["c", "d"], [3, 4]),
        ("match", ["a"]), ("retain", ["e"], [5]), ("hot", 9), ("release", 2),
        ("stats",), ("evict_all",), ("stats",)],
    "install-and-errors": [
        ("retain", ["a", "b"], [1]), ("install", "k", 6), ("install", "k", 6),
        ("match", ["k"]), ("evict_all",), ("stats",)],
}


@pytest.mark.parametrize("script", STORE_SCRIPTS.values(), ids=STORE_SCRIPTS.keys())
def test_prefix_store_matches_jax(script):
    """Both stores over pools whose pages a 'slot' also holds (refcount 2
    for pages 1-2), with a demote hook recording (key, page)."""
    sides = []
    for pool_cls, store_cls, kw in (
            (jpagepool.PagePool, jprefixcache.PrefixStore, {"track_metrics": False}),
            (tpagepool.PagePool, tprefixcache.PrefixStore, {})):
        pool = pool_cls(8, 4, page_bytes=100, **kw)
        pool.alloc(6)
        demoted = []
        store = store_cls(450, 4, pool, demote=lambda k, p, d=demoted: d.append((k, p)))
        sides.append((store, pool, demoted))
    _replay(sides[0][0], sides[1][0], script)
    assert sides[0][1].stats() == sides[1][1].stats()
    assert sides[0][2] == sides[1][2]
    for pool_cls, store_cls in ((jpagepool.PagePool, jprefixcache.PrefixStore),
                                (tpagepool.PagePool, tprefixcache.PrefixStore)):
        with pytest.raises(ValueError):
            store_cls(100, 8, pool_cls(2, 4))


def _block(i, nbytes=128):
    k = np.full(nbytes, i, np.uint8)
    return k, k + 1


def test_host_tier_lru_matches_jax():
    script = [("put", f"h{i}", *_block(i)) for i in range(3)] + [
        ("get", "h0"), ("put", "h3", *_block(3)), ("__contains__", "h1"),
        ("put", "big", *_block(9, 1024)), ("put", "h0", *_block(5, 64)), ("hot", 2),
        ("pop", "h0"), ("pop", "h0"), ("stats",), ("__len__",), ("evict_all",),
        ("stats",)]

    def norm(out):
        # get() returns arrays: compare their bytes.
        if isinstance(out, tuple) and out and isinstance(out[0], np.ndarray):
            return tuple(a.tobytes() for a in out)
        return out

    a, b = jkvtier.HostTier(3 * 256, track_metrics=False), tkvtier.HostTier(3 * 256)
    for step in script:
        name, *args = step
        ra, rb = getattr(a, name)(*args), getattr(b, name)(*args)
        assert norm(ra) == norm(rb), (step, ra, rb)


def test_acceptance_valve_sequence_matches_jax():
    rng = np.random.RandomState(3)
    a = jspec.AcceptanceValve(floor=0.5, window_rounds=4, reprobe_rounds=3)
    b = tspec.AcceptanceValve(floor=0.5, window_rounds=4, reprobe_rounds=3)
    for _ in range(200):
        if rng.rand() < 0.7:
            proposed = int(rng.randint(0, 5))
            accepted = int(rng.randint(0, proposed + 1))
            assert a.observe(proposed, accepted) == b.observe(proposed, accepted)
        else:
            assert a.tick_plain() == b.tick_plain()
        assert (a.open, a.rate()) == (b.open, b.rate())
    assert tspec.DRAFT_KEY_FOLD == jspec.DRAFT_KEY_FOLD
    for kw in ({"floor": 1.5}, {"window_rounds": 0}, {"reprobe_rounds": 0}):
        with pytest.raises(ValueError):
            tspec.AcceptanceValve(**kw)


# ------------------------------------------------------- accept_tokens ----


def _peaked(vocab, tokens):
    out = np.full((len(tokens), vocab), -30.0, np.float32)
    for i, t in enumerate(tokens):
        out[i, t] = 30.0
    return out


ACCEPT_CASES = {
    # (target argmaxes, proposals, spec row): want (emitted tokens)
    "all-accept-plus-bonus": ([2, 5, 1, 7], [2, 5, 1], True),
    "reject-at-0": ([3, 5, 1, 7], [2, 5, 1], True),
    "reject-at-1": ([2, 6, 1, 7], [2, 5, 1], True),
    "reject-at-2": ([2, 5, 4, 7], [2, 5, 1], True),
    "spec-mask-off": ([3, 5, 1, 7], [3, 5, 1], False),
}


@pytest.mark.parametrize("case", ACCEPT_CASES.values(), ids=ACCEPT_CASES.keys())
def test_accept_tokens_greedy_matches_jax(case):
    tgt_tokens, props, spec = case
    V = 8
    tgt = _peaked(V, tgt_tokens)[None]
    dlog = _peaked(V, props)[None]
    keys = jax.random.PRNGKey(0)[None]
    jout, jn, _ = jspec.accept_tokens(
        jnp.asarray(tgt), jnp.asarray([props], jnp.int32), jnp.asarray(dlog),
        jnp.zeros(1, jnp.float32), keys, jnp.asarray([spec]))
    tout, tn = tspec.accept_tokens(
        torch.tensor(tgt), torch.tensor([props]), torch.tensor(dlog), torch.zeros(1),
        torch.rand(1, 4), torch.tensor([spec]))
    n = int(np.asarray(jn)[0])
    assert int(tn[0]) == n
    assert tout[0, :n].tolist() == np.asarray(jout)[0, :n].tolist()


def test_accept_tokens_greedy_random_rows_match_jax():
    rng = np.random.RandomState(4)
    B, K, V = 16, 3, 6
    tgt = rng.randn(B, K + 1, V).astype(np.float32)
    dlog = rng.randn(B, K, V).astype(np.float32)
    # Proposals agree with the target's argmax for a random prefix length.
    props = tgt[:, :K].argmax(-1)
    cut = rng.randint(0, K + 1, B)
    for b in range(B):
        props[b, cut[b]:] = (props[b, cut[b]:] + 1) % V
    spec = rng.rand(B) < 0.8
    jout, jn, _ = jspec.accept_tokens(
        jnp.asarray(tgt), jnp.asarray(props, jnp.int32), jnp.asarray(dlog),
        jnp.zeros(B, jnp.float32), jax.random.split(jax.random.PRNGKey(1), B),
        jnp.asarray(spec))
    tout, tn = tspec.accept_tokens(
        torch.tensor(tgt), torch.tensor(props), torch.tensor(dlog), torch.zeros(B),
        torch.rand(B, K + 1), torch.tensor(spec))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for b in range(B):
        n = int(tn[b])
        assert tout[b, :n].tolist() == np.asarray(jout)[b, :n].tolist()


def test_accept_tokens_certain_reject_and_certain_accept():
    V = 8
    # p(d) ~ e^-60: rejection for any uniform above it, the residual's
    # point mass at 4.
    tgt = np.stack([_peaked(V, [4])[0], _peaked(V, [5])[0]])[None]
    for u in (1e-3, 0.5, 0.999):
        out, n = tspec.accept_tokens(
            torch.tensor(tgt), torch.tensor([[0]]), torch.tensor(_peaked(V, [0])[None]),
            torch.ones(1), torch.full((1, 2), u), torch.tensor([True]))
        assert int(n[0]) == 1 and int(out[0, 0]) == 4
    # p == q: every proposal accepted, the bonus from the last position.
    peaked = [2, 5, 6]
    for u in (1e-3, 0.5, 0.999):
        out, n = tspec.accept_tokens(
            torch.tensor(_peaked(V, peaked)[None]), torch.tensor([peaked[:2]]),
            torch.tensor(_peaked(V, peaked[:2])[None]), torch.ones(1),
            torch.full((1, 3), u), torch.tensor([True]))
        assert int(n[0]) == 3 and out[0].tolist() == peaked


def test_accept_tokens_sampled_marginal_is_the_target():
    """The Leviathan identity: with a draft that DISAGREES, the first
    emitted token's marginal is the target distribution. B rows are B
    trials of K=1 speculation, each proposal drawn from q. Chi-square over
    4 cells (3 degrees of freedom): 16.27 is the 0.1% point."""
    B, V = 20000, 4
    p = torch.tensor([0.5, 0.25, 0.15, 0.1])
    q = torch.tensor([0.1, 0.2, 0.3, 0.4])
    g = torch.Generator().manual_seed(123)
    d = torch.multinomial(q.expand(B, V), 1, replacement=True, generator=g)
    out, n = tspec.accept_tokens(
        p.log().expand(B, 2, V).clone(), d, q.log().expand(B, 1, V).clone(),
        torch.ones(B), torch.rand(B, 2, generator=g), torch.ones(B, dtype=torch.bool))
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    expect = p.numpy() * B
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 16.27, (counts, chi2)
    assert set(n.tolist()) <= {1, 2}


def test_sample_is_argmax_or_the_inverse_cdf():
    logits = torch.tensor([[0.0, 3.0, 1.0], [5.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    temps = torch.tensor([0.0, 1.0, 1.0])
    got = tgen.sample(logits, temps, torch.tensor([0.9, 0.999, 0.5]))
    assert got[0] == 1  # greedy row ignores its uniform
    assert got[1] == 2  # the last cell at u ~ 1
    assert got[2] == 1  # the middle third of a uniform row


# ------------------------------------------------------------ engine ----


def test_midflight_admission_greedy_equals_jax_sampled_equals_solo(model):
    """More requests than slots, mixed greedy/sampled and lengths: every
    admission meets a batch mid-decode and every stream still equals its
    solo run."""
    reqs = [([1, 2, 3], 8, 0.0, 0), ([5, 6], 10, 0.7, 1),
            ([7, 8, 9, 10, 11], 6, 0.0, 2), ([12], 12, 1.3, 3),
            ([3, 1, 4, 1, 5, 9, 2, 6], 7, 0.0, 4), ([42, 17], 9, 0.5, 5)]
    eng = engine(model)
    try:
        handles = [eng.submit(p, max_new=n, temperature=t, seed=s) for p, n, t, s in reqs]
        outs = [h.result(timeout=60) for h in handles]
    finally:
        eng.stop(timeout=30)
    for (p, n, t, s), out in zip(reqs, outs):
        assert out == solo(model, p, n, t, s), (p, t, s)
    st = {**eng.stats(), **eng.request_stats()}
    assert st["finished_total"] == 6 and eng.error is None
    assert st["decode_tokens"] == sum(n for _, n, _, _ in reqs) - len(reqs)


def test_sampled_stream_is_independent_of_batch_mates(model):
    eng = engine(model, max_batch=4)
    try:
        alone = eng.submit([9, 9, 1], max_new=10, temperature=0.9, seed=11).result(timeout=60)
        mates = [eng.submit([i, 3], max_new=12, temperature=1.1, seed=i) for i in range(3)]
        crowd = eng.submit([9, 9, 1], max_new=10, temperature=0.9, seed=11)
        got = crowd.result(timeout=60)
        for h in mates:
            h.result(timeout=60)
    finally:
        eng.stop(timeout=30)
    assert got == alone == solo(model, [9, 9, 1], 10, 0.9, 11)


def test_slot_reuse_leaks_nothing(model):
    eng = engine(model, max_batch=1, queue_depth=8)
    try:
        for prompt, n_new in (([9] * 40, 8), ([9], 8), ([5, 5, 5], 5)):
            assert eng.submit(prompt, max_new=n_new).result(timeout=60) == solo(
                model, prompt, n_new), prompt
    finally:
        eng.stop(timeout=30)


def test_queue_full_refuses_and_cancel_evicts(model):
    eng = engine(model, max_batch=1, max_seq=512, queue_depth=1)
    try:
        resident = eng.submit([1], max_new=400)
        assert wait_for(lambda: eng.active_slots == 1)
        queued = eng.submit([2], max_new=400)  # fills the 1-deep queue
        with pytest.raises(QueueFull):
            eng.submit([3], max_new=2)
        assert resident.finish_reason == ""
        resident.cancel()
        queued.cancel()
        assert wait_for(lambda: eng.active_slots == 0 and eng.queue_len == 0)
        resident.result(timeout=30)
        queued.result(timeout=30)
        assert resident.finish_reason == queued.finish_reason == "cancelled"
        assert eng.submit([4, 5], max_new=4).result(timeout=60) == solo(
            model, [4, 5], 4, max_seq=512)
    finally:
        eng.stop(timeout=30)
    assert eng.pool_stats()["used_pages"] == eng.prefix_stats()["entries"]


def test_eos_retires_at_its_first_occurrence(model):
    ref = solo(model, [1, 2, 3], 8)
    eos = ref[1]
    eng = engine(model)
    try:
        h = eng.submit([1, 2, 3], max_new=8, eos=eos)
        assert h.result(timeout=60) == ref[:ref.index(eos) + 1]
        assert h.finish_reason == "eos"
    finally:
        eng.stop(timeout=30)


def test_graceful_drain(model):
    eng = engine(model, max_batch=1, queue_depth=4)
    resident = eng.submit([6, 7], max_new=48)
    assert wait_for(lambda: resident._req.admitted_at > 0, interval=0.0005)
    queued = eng.submit([8], max_new=6)
    eng.stop(drain=True, timeout=60)
    assert resident.result(timeout=5) == solo(model, [6, 7], 48)
    assert resident.finish_reason == "length"
    assert queued.result(timeout=5) == [] and queued.finish_reason == "drained"
    with pytest.raises(Draining):
        eng.submit([1], max_new=2)


def test_inadmissible_requests(model):
    eng = engine(model, max_batch=1, max_seq=16, prefix_cache_bytes=0,
                 kv_pool_tokens=32)
    try:
        for prompt, kw in (([], {}), ([1] * 10, {"max_new": 8}), ([1], {"max_new": -1}),
                           ([1], {"temperature": -0.5})):
            with pytest.raises(ValueError):
                eng.submit(prompt, **kw)
    finally:
        eng.stop(timeout=30)
    small = engine(model, max_batch=2, max_seq=64, prefix_cache_bytes=0, kv_pool_tokens=32)
    try:
        with pytest.raises(ValueError, match="KV pages"):
            small.submit([1] * 20, max_new=20)  # 3 pages > the pool's 2
    finally:
        small.stop(timeout=30)


def test_pool_exhaustion_backpressures_then_recovers(model):
    eng = engine(model, max_seq=512, queue_depth=1, prefix_cache_bytes=0,
                 kv_pool_tokens=416)
    try:
        resident = eng.submit([1, 2, 3, 4], max_new=400)  # reserves all 26 pages
        assert wait_for(lambda: eng.active_slots == 1)
        queued = eng.submit([5, 6], max_new=4)
        assert wait_for(lambda: eng.request_stats()["pool_blocked_episodes"] == 1)
        assert eng.active_slots == 1 and eng.queue_len == 1
        with pytest.raises(QueueFull):
            eng.submit([7], max_new=2)
        resident.cancel()
        assert queued.result(timeout=60) == solo(model, [5, 6], 4, max_seq=512)
        resident.result(timeout=30)
        assert resident.finish_reason == "cancelled"
    finally:
        eng.stop(timeout=30)
    assert eng.pool_stats()["used_pages"] == 0
    assert eng.pool_stats()["peak_used_pages"] == 26


def test_more_slots_than_dense_memory_would_allow(model):
    eng = engine(model, max_batch=4, queue_depth=8, prefix_cache_bytes=0,
                 kv_pool_tokens=128)
    reqs = [([3 + i, 4, 5], 30, 0.0 if i % 2 else 0.9, i) for i in range(4)]
    try:
        handles = [eng.submit(p, max_new=n, temperature=t, seed=s) for p, n, t, s in reqs]
        assert wait_for(lambda: eng.active_slots == 4)
        assert eng.pool_stats()["used_pages"] <= eng.pool_stats()["total_pages"] == 8
        for (p, n, t, s), h in zip(reqs, handles):
            assert h.result(timeout=60) == solo(model, p, n, t, s)
    finally:
        eng.stop(timeout=30)


def test_prefix_hits_are_identical_and_zero_copy(model):
    eng = engine(model, prefix_block=4)
    shared = np.random.RandomState(2).randint(1, 64, 13).tolist()
    reqs = [(shared + [7, 8], 6, 0.0, 0), (shared + [9], 6, 0.7, 1),
            (shared + [10, 11], 5, 0.0, 2), (shared + [7, 8], 6, 1.1, 3),
            ([1, 2, 3], 4, 0.9, 4)]
    outs = []
    try:
        for p, n, t, s in reqs:
            h = eng.submit(p, max_new=n, temperature=t, seed=s)
            outs.append((h.result(timeout=60), h.stats))
        chain = tprefixhash.usable_hashes(shared + [2], 4)
        store_pages = [eng._prefix.page_of(h) for h in chain[:3]]
        resident = eng.submit(shared + [2], max_new=30)
        assert wait_for(lambda: resident._req.admitted_at > 0, interval=0.0005)
        assert eng._slot_pages[0][:3] == store_pages  # the store's own pages
        resident.result(timeout=60)
    finally:
        eng.stop(timeout=30)
    for (p, n, t, s), (out, _) in zip(reqs, outs):
        assert out == solo(model, p, n, t, s), (p, t, s)
    assert [st["prefix_tokens"] for _, st in outs] == [0, 12, 12, 12, 0]
    st = eng.request_stats()
    assert (st["prefix_hits"], st["prefill_tokens_cached"]) == (4, 48)
    eng.evict_prefix_store()
    assert eng.pool_stats()["used_pages"] == 0


def test_cow_divergence_mid_block_never_corrupts_the_chain(model):
    eng = engine(model, prefix_block=4)
    a = [11, 12, 13, 14, 21, 22, 23, 24, 9]
    b = a[:6] + [40, 41, 9]
    try:
        first = eng.submit(a, max_new=4, temperature=0.6, seed=5)
        assert first.result(timeout=60) == solo(model, a, 4, 0.6, 5)
        div = eng.submit(b, max_new=4)
        assert div.result(timeout=60) == solo(model, b, 4)
        assert div.stats["prefix_tokens"] == 4
        again = eng.submit(a, max_new=4, temperature=0.6, seed=5)
        assert again.result(timeout=60) == solo(model, a, 4, 0.6, 5)
        assert again.stats["prefix_tokens"] == 8
    finally:
        eng.stop(timeout=30)


def test_host_tier_promotion_is_identical(model):
    """Evicting the store demotes the chain into host RAM; the next
    request promotes it into fresh pages and matches its first run."""
    eng = engine(model, max_batch=1, prefix_block=4, kv_host_bytes=1 << 20)
    p = np.random.RandomState(7).randint(1, 64, 14).tolist()
    try:
        first = eng.submit(p, max_new=6).result(timeout=60)
        sampled = eng.submit(p + [3], max_new=6, temperature=0.8, seed=2).result(timeout=60)
        freed = eng.evict_prefix_store()  # the engine is idle between requests
        assert freed == 3 and eng.pool_stats()["used_pages"] == 0
        assert eng.host_stats()["entries"] == 3
        assert eng.hot_prefixes() == []  # the chain lives in host RAM only
        h = eng.submit(p, max_new=6)
        assert h.result(timeout=60) == first == solo(model, p, 6)
        assert h.stats["prefix_tokens"] == 12
        hs = eng.submit(p + [3], max_new=6, temperature=0.8, seed=2)
        assert hs.result(timeout=60) == sampled == solo(model, p + [3], 6, 0.8, 2)
        assert eng.host_stats()["promotions"] == 3
        assert eng.host_stats()["entries"] == 0
    finally:
        eng.stop(timeout=30)
    eng.evict_prefix_store()
    eng.evict_host_tier()
    assert eng.pool_stats()["used_pages"] == 0
    assert eng.pool_stats()["tiers"]["host"]["entries"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_demote_promote_round_trip_is_byte_exact(dtype):
    rng = torch.Generator().manual_seed(0)
    pool = {k: torch.randn(2, 5, 4, 2, 8, generator=rng).to(dtype) for k in ("k", "v")}
    before = {k: t.clone() for k, t in pool.items()}
    k3, v3 = tkvtier.page_kv(pool, 3)
    k1, v1 = tkvtier.page_kv(pool, 1)
    assert k3.shape == (2, 4, 2, 8) and k3.dtype.itemsize == dtype.itemsize
    tkvtier.stage_page(pool, 2, k3, v3)
    assert torch.equal(pool["k"][:, 2].view(torch.int16 if dtype == torch.bfloat16 else
                                            torch.int32),
                       before["k"][:, 3].view(torch.int16 if dtype == torch.bfloat16 else
                                              torch.int32))
    tkvtier.stage_page(pool, 4, k1, v1)
    tkvtier.stage_page(pool, 0, k3, v3)
    assert torch.equal(pool["v"][:, 4], before["v"][:, 1])
    assert torch.equal(pool["v"][:, 0], before["v"][:, 3])
    assert torch.equal(pool["k"][:, 1], before["k"][:, 1])  # the source is untouched


def test_chunked_prefill_is_identical(model):
    """A 30-token prompt in 8-token slices while another request decodes:
    both streams equal their solo runs, and the chunked request's prefix
    hit resumes mid-chain."""
    eng = engine(model, prefix_block=4, prefill_chunk=8)
    long_p = np.random.RandomState(5).randint(1, 64, 30).tolist()
    try:
        resident = eng.submit([1, 2], max_new=40, temperature=0.7, seed=3)
        assert wait_for(lambda: resident._req.admitted_at > 0, interval=0.0005)
        h = eng.submit(long_p, max_new=8, temperature=0.5, seed=1)
        assert h.result(timeout=60) == solo(model, long_p, 8, 0.5, 1)
        assert resident.result(timeout=60) == solo(model, [1, 2], 40, 0.7, 3)
        again = eng.submit(long_p + [6], max_new=5)
        assert again.result(timeout=60) == solo(model, long_p + [6], 5)
        assert again.stats["prefix_tokens"] == 28
    finally:
        eng.stop(timeout=30)


def test_drain_and_cancel_release_every_page(model):
    eng = engine(model, prefix_block=4)
    resident = eng.submit([1] * 9, max_new=40)
    victim = eng.submit([2] * 9, max_new=40)
    assert wait_for(lambda: eng.active_slots == 2 or victim.finish_reason)
    victim.cancel()
    assert wait_for(lambda: victim.finish_reason != "")
    eng.stop(drain=True, timeout=60)
    assert resident.finish_reason == "length"
    assert eng.prefix_stats()["bytes"] > 0
    eng.evict_prefix_store()
    assert eng.pool_stats()["used_pages"] == 0


def test_ungraceful_stop_releases_without_retaining(model):
    eng = engine(model, max_batch=1, prefix_block=4)
    h = eng.submit([4] * 9, max_new=40)
    assert wait_for(lambda: h._req.admitted_at > 0, interval=0.0005)
    eng.stop(drain=False, timeout=30)
    eng.evict_prefix_store()
    assert eng.pool_stats()["used_pages"] == 0
    assert h.finish_reason in ("drained", "length")


# ------------------------------------------------------ speculation ----


def test_spec_self_draft_greedy_equals_plain(model):
    _, tp, _, tcfg = model
    eng = engine(model, draft_params=tp, draft_cfg=tcfg, spec_tokens=3)
    reqs = [([1 + i, 5, 9, 2], 10) for i in range(5)]
    try:
        handles = [eng.submit(p, max_new=n, seed=i) for i, (p, n) in enumerate(reqs)]
        for (p, n), h in zip(reqs, handles):
            assert h.result(timeout=60) == solo(model, p, n)
        st = eng.stats()
        assert st["spec_accepted"] > 0 and st["decode_tokens"] > st["target_steps"]
        sampled = eng.submit([4, 4], max_new=9, temperature=0.9, seed=42)
        assert len(sampled.result(timeout=60)) == 9
    finally:
        eng.stop(timeout=30)
    assert eng.spec_stats()["draft_used_pages"] == 0


def test_spec_disagreeing_draft_greedy_equals_plain(model, draft_model):
    dparams, dcfg = draft_model
    eng = engine(model, max_batch=4, draft_params=dparams, draft_cfg=dcfg, spec_tokens=4)
    try:
        greedy = [([2 + i, 7, 3], 9) for i in range(3)]
        gh = [eng.submit(p, max_new=n, seed=i) for i, (p, n) in enumerate(greedy)]
        sh = eng.submit([9, 8, 7], max_new=9, temperature=0.9, seed=42)
        for (p, n), h in zip(greedy, gh):
            assert h.result(timeout=60) == solo(model, p, n)
        assert len(sh.result(timeout=60)) == 9
        assert eng.stats()["spec_proposed"] > 0
    finally:
        eng.stop(timeout=30)


def test_spec_mixed_spec_and_plain_slots(model):
    _, tp, _, tcfg = model
    eng = engine(model, queue_depth=8, draft_params=tp, draft_cfg=tcfg, spec_tokens=3,
                 spec_pool_tokens=32)  # room for ONE request's draft pages
    try:
        h1 = eng.submit([1, 2, 3], max_new=16)
        h2 = eng.submit([4, 5, 6], max_new=16)
        assert wait_for(lambda: eng.active_slots == 2 or h1.finish_reason)
        assert sum(eng._spec_row) <= 1
        assert h1.result(timeout=60) == solo(model, [1, 2, 3], 16)
        assert h2.result(timeout=60) == solo(model, [4, 5, 6], 16)
        h3 = eng.submit([7, 8, 9], max_new=16)
        assert h3.result(timeout=60) == solo(model, [7, 8, 9], 16)
    finally:
        eng.stop(timeout=30)
    assert eng.spec_stats()["draft_used_pages"] == 0


def test_spec_hostile_draft_trips_the_valve_and_stays_identical(model, draft_model):
    dparams, dcfg = draft_model
    eng = engine(model, max_batch=1, queue_depth=4, draft_params=dparams, draft_cfg=dcfg,
                 spec_tokens=4, spec_accept_floor=0.999, spec_window_rounds=3,
                 spec_reprobe_rounds=4)
    try:
        assert eng.submit([3, 1, 4], max_new=28).result(timeout=60) == solo(
            model, [3, 1, 4], 28)
        st = eng.stats()
        assert st["spec_fallbacks"] >= 1
        assert eng.spec_stats()["draft_used_pages"] == 0
        # The cooldown lapsed during the plain tail: the valve reopened.
        assert eng.submit([5, 9, 2], max_new=12).result(timeout=60) == solo(
            model, [5, 9, 2], 12)
        assert eng.stats()["spec_rounds"] > st["spec_rounds"]
    finally:
        eng.stop(timeout=30)


def test_spec_eos_mid_round_and_cancel(model):
    _, tp, _, tcfg = model
    eng = engine(model, draft_params=tp, draft_cfg=tcfg, spec_tokens=3)
    ref = solo(model, [2, 4, 6], 16)
    eos = ref[len(ref) // 2]
    try:
        h = eng.submit([2, 4, 6], max_new=16, eos=eos)
        assert h.result(timeout=60) == ref[:ref.index(eos) + 1]
        assert h.finish_reason == "eos"
        c = eng.submit([1, 2, 3], max_new=60)
        assert wait_for(lambda: c._req.emitted > 0)
        c.cancel()
        assert wait_for(lambda: c.finish_reason != "")
        assert c.finish_reason in ("cancelled", "length")
        assert wait_for(lambda: eng.spec_stats()["draft_used_pages"] == 0)
    finally:
        eng.stop(timeout=30)


# ------------------------------------------------ refusals and rules ----


def test_engine_refuses_bad_spec_configs(model):
    _, tp, _, tcfg = model
    with pytest.raises(ValueError, match="draft_params AND"):
        engine(model, spec_tokens=2)
    with pytest.raises(ValueError, match="vocab"):
        engine(model, draft_params=tp, draft_cfg=dataclasses.replace(tcfg, vocab=32),
               spec_tokens=2)
    with pytest.raises(ValueError, match="prefix_block"):
        engine(model, kv_page_tokens=8, prefix_block=4)


def test_engine_defaults_to_cuda(model):
    import inspect

    _, tp, _, tcfg = model
    assert inspect.signature(ServeEngine).parameters["device"].default == "cuda"
    assert inspect.signature(tgen.init_page_pool).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tp, tcfg)


_ROOT = Path(__file__).resolve().parent.parent
_SERVING = ["oim_tpu_torch/models/generate.py", "oim_tpu_torch/common/prefixhash.py",
            "oim_tpu_torch/serve/__init__.py", "oim_tpu_torch/serve/pagepool.py",
            "oim_tpu_torch/serve/prefixcache.py", "oim_tpu_torch/serve/kvtier.py",
            "oim_tpu_torch/serve/spec.py", "oim_tpu_torch/serve/engine.py",
            "oim_tpu_torch/serve/shard.py"]


def test_serving_modules_import_only_stdlib_numpy_torch_and_the_port():
    """The card machine lists no grpc, protobuf or prometheus_client."""
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch", "oim_tpu_torch"}
    bad = []
    for rel in _SERVING:
        for node in ast.walk(ast.parse((_ROOT / rel).read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            bad += [f"{rel}: {n}" for n in names if n.split(".")[0] not in allowed]
    assert not bad, bad
