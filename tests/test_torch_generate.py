"""The port's decoding module (oim_tpu_torch.models.generate) held against
the JAX package's on the CPU: llama.tiny (vocab 64, dim 32, 2 layers, as
tests/test_serve.py), JAX-initialized weights carried across with
from_numpy, the same numpy tokens, page tables and positions through both.

Tolerances: f32 2e-5 absolute (plus 1e-5 relative on logits: two
frameworks' f32 products sum in different orders); bf16 2^-6 x max|JAX|
(a few bf16 steps of the largest value). Pools are compared without
scratch page 0, whose content is garbage by design and which the port
writes where the reference drops. Greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import generate as jgen
from oim_tpu.models import llama as jllama
from oim_tpu_torch.models import generate as tgen
from oim_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

F32 = dict(atol=2e-5, rtol=1e-5)
BF16_REL = 2.0 ** -6


def _configs(**kw):
    jcfg = dataclasses.replace(jllama.tiny(vocab=64, dim=32, n_layers=2), **kw)
    tcfg = dataclasses.replace(tllama.tiny(vocab=64, dim=32, n_layers=2), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    return jp, tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), jcfg, tcfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or F32))


def _pools_close(tpool, jpool):
    for key in ("k", "v"):
        _close(tpool[key][:, 1:], jpool[key][:, 1:])


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------- attention ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-pos", "row-pos"])
def test_cache_attention_matches_jax(dtype, per_row):
    jcfg, tcfg = _configs()
    B, T, S, H, kvh, hd = 3, 4, 24, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    rng = np.random.RandomState(1)
    q = rng.randn(B, T, H, hd).astype(np.float32)
    ck = rng.randn(B, S, kvh, hd).astype(np.float32)
    cv = rng.randn(B, S, kvh, hd).astype(np.float32)
    pos = np.array([0, 7, 20], np.int32) if per_row else 5
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jgen._cache_attention(
        *(jnp.asarray(x, jd) for x in (q, ck, cv)), jnp.asarray(pos), jcfg)
    got = tgen._cache_attention(
        *(_t(x).to(td) for x in (q, ck, cv)),
        _t(pos).long() if per_row else pos, tcfg)
    assert got.dtype == td and got.shape == (B, T, H, hd)
    if dtype == "float32":
        _close(got, want, atol=2e-5)
    else:
        _close(got, want, atol=BF16_REL * float(np.abs(_np(want)).max()))


# -------------------------------------------------- dense cache ----


def test_cached_forward_prefill_then_decode_matches_jax(model):
    jp, tp, jcfg, tcfg = model
    prompt = np.random.RandomState(2).randint(0, 64, (2, 7)).astype(np.int32)
    jcache, tcache = jgen.init_cache(jcfg, 2, 16), tgen.init_cache(tcfg, 2, 16, device="cpu")
    jl, jcache = jgen.cached_forward(jp, jnp.asarray(prompt), jcache, 0, jcfg)
    tl, tcache = tgen.cached_forward(tp, _t(prompt), tcache, 0, tcfg)
    _close(tl, jl)
    for pos, tok in zip(range(7, 10), ([3, 9], [60, 1], [5, 5])):
        tok = np.asarray(tok, np.int32)[:, None]
        jl, jcache = jgen.cached_forward(jp, jnp.asarray(tok), jcache, pos, jcfg)
        tl, tcache = tgen.cached_forward(tp, _t(tok), tcache, pos, tcfg)
        assert tl.shape == (2, 1, 64) and tl.dtype == torch.float32
        _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


# ------------------------------------------------------ paged steps ----

PAGE = 4
TABLE = np.array([3, 1, 5, 2, 6, 4], np.int32)  # 6 blocks: S = 24, shuffled pages


def _pools(jcfg, tcfg, n_pages=8):
    return (jgen.init_page_pool(jcfg, n_pages, PAGE),
            tgen.init_page_pool(tcfg, n_pages, PAGE, device="cpu"))


def _prefill_both(jp, tp, jcfg, tcfg, jpool, tpool, tokens, n, table, start, bucket):
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(tokens)] = tokens
    jl, jpool = jgen.prefill_into_pages(
        jp, jnp.asarray(padded), jnp.int32(n), jpool, jnp.asarray(table),
        jnp.int32(start), jcfg, PAGE)
    tl, tpool = tgen.prefill_into_pages(
        tp, _t(padded), n, tpool, _t(table), start, tcfg, PAGE)
    return jl, jpool, tl, tpool


@pytest.mark.parametrize("hit", [False, True], ids=["full", "prefix-hit"])
def test_prefill_into_pages_matches_jax(model, hit):
    jp, tp, jcfg, tcfg = model
    prompt = np.random.RandomState(3).randint(0, 64, 11).tolist()
    jpool, tpool = _pools(jcfg, tcfg)
    if hit:
        # The first 2 blocks land first; then the 3-token tail, padded to
        # 8, prefills at start = 2 blocks against the pages in place.
        jl, jpool, tl, tpool = _prefill_both(
            jp, tp, jcfg, tcfg, jpool, tpool, prompt[:8], 8, TABLE, 0, 8)
        jl, jpool, tl, tpool = _prefill_both(
            jp, tp, jcfg, tcfg, jpool, tpool, prompt[8:], 3, TABLE, 8, 8)
    else:
        jl, jpool, tl, tpool = _prefill_both(
            jp, tp, jcfg, tcfg, jpool, tpool, prompt, 11, TABLE, 0, 16)
    assert tl.shape == (64,) and tl.dtype == torch.float32
    _close(tl, jl)
    _pools_close(tpool, jpool)
    # Pad positions 11..15 never land: offset 3 of block 2's page and all
    # of block 3's page stay zero.
    assert not tpool["k"][:, TABLE[2], 3].any()
    assert not tpool["k"][:, TABLE[3]].any()


def test_decode_step_rows_at_different_depths_and_an_idle_row(model):
    jp, tp, jcfg, tcfg = model
    rng = np.random.RandomState(4)
    jpool, tpool = _pools(jcfg, tcfg, n_pages=12)
    tables = np.zeros((3, 3), np.int32)  # S = 12
    tables[0] = [1, 2, 3]
    tables[1] = [7, 4, 9]
    for row, n in ((0, 5), (1, 9)):
        toks = rng.randint(0, 64, n).tolist()
        _, jpool, _, tpool = _prefill_both(
            jp, tp, jcfg, tcfg, jpool, tpool, toks, n, tables[row], 0, 16)
    # Row 2 is idle: all-zero table, position clamped at max_seq = S.
    pos = np.array([5, 9, 12], np.int32)
    for step in range(3):
        tok = rng.randint(0, 64, 3).astype(np.int32)
        jl, jpool = jgen.decode_step(jp, jnp.asarray(tok), jpool, jnp.asarray(tables),
                                     jnp.asarray(pos), jcfg, PAGE)
        tl, tpool = tgen.decode_step(tp, _t(tok), tpool, _t(tables), _t(pos), tcfg, PAGE)
        assert tl.shape == (3, 64)
        _close(tl[:2], jl[:2])
        pos = np.minimum(pos + 1, 12)
    _pools_close(tpool, jpool)


def test_verify_step_with_a_row_past_its_table(model):
    jp, tp, jcfg, tcfg = model
    rng = np.random.RandomState(5)
    jpool, tpool = _pools(jcfg, tcfg, n_pages=10)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # S = 16
    for row, n in ((0, 13), (1, 4)):
        toks = rng.randint(0, 64, n).tolist()
        _, jpool, _, tpool = _prefill_both(
            jp, tp, jcfg, tcfg, jpool, tpool, toks, n, tables[row], 0, 16)
    cand = rng.randint(0, 64, (2, 5)).astype(np.int32)
    pos = np.array([13, 4], np.int32)  # row 0: positions 13..17, 16-17 past the table
    jl, jpool = jgen.verify_step(jp, jnp.asarray(cand), jpool, jnp.asarray(tables),
                                 jnp.asarray(pos), jcfg, PAGE)
    tl, tpool = tgen.verify_step(tp, _t(cand), tpool, _t(tables), _t(pos), tcfg, PAGE)
    assert tl.shape == (2, 5, 64)
    _close(tl, jl)
    _pools_close(tpool, jpool)


def test_verify_step_equals_sequential_decode_steps(model):
    _, tp, _, tcfg = model
    table = torch.arange(1, 5)[None]
    prompt = [3, 1, 4, 1, 5]

    def fresh():
        pool = tgen.init_page_pool(tcfg, 6, PAGE, device="cpu")
        padded = torch.zeros(1, 8, dtype=torch.long)
        padded[0, :5] = torch.tensor(prompt)
        return tgen.prefill_into_pages(tp, padded, 5, pool, table[0], 0, tcfg, PAGE)[1]

    cand = [9, 2, 6, 5]
    pool = fresh()
    seq = [tgen.decode_step(tp, torch.tensor([t]), pool, table, torch.tensor([5 + j]),
                            tcfg, PAGE)[0][0] for j, t in enumerate(cand)]
    vl, _ = tgen.verify_step(tp, torch.tensor([cand]), fresh(), table, torch.tensor([5]),
                             tcfg, PAGE)
    for j in range(4):
        assert int(vl[0, j].argmax()) == int(seq[j].argmax())
        _close(vl[0, j], seq[j])


# ------------------------------------------------------- generate ----


@pytest.mark.parametrize("shape,n_new", [((1, 3), 8), ((2, 7), 6), ((1, 1), 12)])
def test_generate_greedy_tokens_equal_jax(model, shape, n_new):
    jp, tp, jcfg, tcfg = model
    prompt = np.random.RandomState(shape[1]).randint(0, 64, shape).astype(np.int32)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), n_new, jcfg, max_seq=32))
    got = tgen.generate(tp, _t(prompt).long(), n_new, tcfg, max_seq=32)
    assert got.shape == (shape[0], shape[1] + n_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampled_is_a_function_of_the_generator(model):
    _, tp, _, tcfg = model
    prompt = torch.tensor([[1, 2, 3]])

    def run(seed):
        return tgen.generate(tp, prompt, 10, tcfg, temperature=0.8,
                             rng=torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :3], prompt) and int(a.max()) < tcfg.vocab


def test_generate_edges_and_refusals(model):
    _, tp, _, tcfg = model
    prompt = torch.tensor([[1, 2, 3]])
    assert tgen.generate(tp, prompt, 0, tcfg) is prompt
    with pytest.raises(ValueError, match="n_new"):
        tgen.generate(tp, prompt, -1, tcfg)
    with pytest.raises(ValueError, match="max_seq"):
        tgen.generate(tp, prompt, 8, tcfg, max_seq=6)
    # Tensor-parallel decode (tests/test_torch_shard.py) refuses MoE, as
    # the reference's shard_config does.
    moe = dataclasses.replace(tcfg, n_experts=4)
    pool = tgen.init_page_pool(moe, 3, PAGE, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tgen.decode_step(tp, torch.tensor([1]), pool, torch.ones(1, 2, dtype=torch.long),
                         torch.tensor([0]), moe, PAGE, axis=object())


def test_shard_config_and_pool_shapes_match_jax():
    jcfg, tcfg = _configs()
    for n in (1, 2):
        js, ts = jgen.shard_config(jcfg, n), tgen.shard_config(tcfg, n)
        assert (js.n_heads, js.n_kv_heads) == (ts.n_heads, ts.n_kv_heads)
    for n in (0, 3):
        with pytest.raises(ValueError):
            tgen.shard_config(tcfg, n)
    jpool, tpool = _pools(jcfg, tcfg, n_pages=5)
    assert tuple(jpool["k"].shape) == tuple(tpool["k"].shape)
    assert tuple(jgen.init_cache(jcfg, 2, 8)["v"].shape) == tuple(
        tgen.init_cache(tcfg, 2, 8, device="cpu")["v"].shape)
    moe = dataclasses.replace(tcfg, n_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
    assert tgen._no_drop(moe).moe_capacity_factor == jgen._no_drop(
        dataclasses.replace(jcfg, n_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
    ).moe_capacity_factor == 2.0
