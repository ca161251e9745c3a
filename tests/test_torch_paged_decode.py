"""The paged-decode kernel (``kernels.paged_decode``) and the serving steps'
dispatch to it (``generate._paged_attention``).

On the CPU: a CPU pool keeps the plain path, ``_gather`` and
``_cache_attention``, bit for bit (the steps' logits against the same steps
with the plain path patched in); the kernel's wrapper refuses CPU tensors
(no fallback); the host's split rule leaves no split of any live length
uncovered or past its table bound.

On the card (marked ``card``; each test skips without a CUDA device): the
kernel against the plain path in the working dtype over ragged positions,
page boundaries, an idle row on scratch page 0, shared and stale pages,
T = 1 and 5, groups 1, 4 and 8, head_dim 16, 64 and 128, each route
(bf16 at head_dim 13, 20 and f32 take the CUDA-core one); whole
``decode_step`` and ``verify_step`` calls at llama.tiny and at 4 layers of
Mistral-7B's widths; greedy engine streams; launch counts. Run them on the
card with ``python -m pytest tests/test_torch_paged_decode.py --noconftest
-q`` (the card machine has no JAX, which ``tests/conftest.py`` imports).

Tolerances (kernel against plain, same inputs):
* f32: 1e-5 x max|plain|. Only the order of the f32 sums differs (dots of
  <= 128 terms, softmax sums and PV sums over <= 4k keys, split and
  merged): a few hundred f32 roundings, ~100x f32's epsilon at the most.
* bf16: 2^-6 x max|plain| (K1's tolerance in chip_smoke.py). The kernel
  rounds each probability to bf16 before it is normalised (against the
  split's running max, as K1 does), the plain path after: each weight
  differs by <= 2^-8 relative, the output by <= 2^-8 x max|v| before its
  own bf16 rounding (one more 2^-8 of it).
* logits of whole steps: 2^-4 x max|logit| at bf16 (``SERVE_LOGIT_REL``,
  chip_smoke.py phase 7's limit for paged against solo logits); 1e-4 x
  max|logit| at f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from oim_tpu_torch import kernels
from oim_tpu_torch.models import generate as gen
from oim_tpu_torch.models import llama

F32_REL = 1e-5
BF16_REL = 2.0 ** -6
LOGIT_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -4}


def _plain(q, pk, pv, tables, pos, cfg, page_tokens):
    """The seed's paged attention: the whole table gathered, then
    ``_cache_attention``."""
    S = tables.shape[1] * page_tokens
    return gen._cache_attention(q, gen._gather(pk, tables, S), gen._gather(pv, tables, S),
                                pos, cfg)


def _attn_cfg(h, kvh, hd, dtype):
    return dataclasses.replace(llama.tiny(), n_heads=h, n_kv_heads=kvh, head_dim=hd,
                               dim=h * hd, dtype=dtype)


def _case(seed, b, t, g, kvh, hd, page, nb, pos, dtype, device, share=False, idle=()):
    """q, a pool of random (stale) pages, per-row tables of distinct pages
    (rows share their first pages where ``share``), rows in ``idle`` on an
    all-zero table at pos = S."""
    rs = np.random.RandomState(seed)
    n_pages = 1 + b * nb
    q = torch.tensor(rs.randn(b, t, g * kvh, hd), dtype=torch.float32)
    pk = torch.tensor(rs.randn(n_pages, page, kvh, hd), dtype=torch.float32)
    pv = torch.tensor(rs.randn(n_pages, page, kvh, hd), dtype=torch.float32)
    # Large stale keys in every page: a kernel that weighed a key past a
    # row's position would move the output far beyond the tolerance.
    pk[:, page // 2:] *= 8.0
    perm = 1 + rs.permutation(n_pages - 1)
    tables = torch.tensor(perm[:b * nb].reshape(b, nb), dtype=torch.int64)
    if share and b > 1:
        tables[1:, :nb // 2] = tables[0, :nb // 2]
    pos = torch.tensor(pos, dtype=torch.int64)
    for r in idle:
        tables[r] = 0
        pos[r] = nb * page
    out = [x.to(dtype).to(device) for x in (q, pk, pv)]
    return (*out, tables.to(device), pos.to(device))


# (seed, B, T, group, kvh, head_dim, page, n_blocks, pos, share, idle)
CASES = [
    ("ragged", 0, 6, 1, 4, 2, 128, 16, 8, [0, 1, 15, 16, 77, 127], False, ()),
    ("page_edges", 1, 6, 1, 4, 2, 128, 16, 4, [14, 15, 16, 17, 31, 32], False, ()),
    ("idle_row", 2, 3, 1, 4, 2, 128, 16, 8, [40, 0, 90], False, (1,)),
    ("shared_stale", 3, 4, 1, 4, 2, 64, 8, 12, [33, 50, 95, 7], True, ()),
    ("verify_t5", 4, 3, 5, 4, 2, 128, 16, 8, [0, 60, 123], False, ()),
    ("verify_past_table", 5, 2, 5, 4, 1, 64, 16, 4, [61, 63], False, ()),
    ("group1", 6, 3, 1, 1, 4, 64, 16, 8, [5, 64, 100], False, ()),
    ("group8", 7, 3, 1, 8, 1, 128, 16, 8, [5, 64, 127], False, ()),
    ("group8_t5", 8, 2, 5, 8, 1, 128, 16, 8, [9, 70], False, ()),
    ("hd16_tiny", 9, 4, 1, 2, 2, 16, 4, 16, [0, 3, 4, 63], False, (3,)),
    ("long_splits", 10, 2, 1, 4, 8, 128, 16, 320, [1399, 5119], True, ()),
    ("odd_hd", 11, 2, 2, 2, 2, 13, 8, 6, [17, 47], False, ()),
    ("hd20", 12, 2, 1, 2, 2, 20, 8, 6, [0, 47], False, ()),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged-decode kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- CPU: the plain path stays the old one ------------------------------------


@pytest.mark.parametrize("name,seed,b,t,g,kvh,hd,page,nb,pos,share,idle", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_is_the_gather_path_bitwise(name, seed, b, t, g, kvh, hd, page, nb, pos,
                                                 share, idle, dtype):
    q, pk, pv, tables, pos_t = _case(seed, b, t, g, kvh, hd, page, nb, pos, dtype, "cpu",
                                     share, idle)
    cfg = _attn_cfg(g * kvh, kvh, hd, dtype)
    got = gen._paged_attention(q, pk, pv, tables, pos_t, cfg, page)
    want = _plain(q, pk, pv, tables, pos_t, cfg, page)
    assert got.dtype == q.dtype and torch.equal(got, want)


def _tiny_steps(cfg, device, seed=0):
    """A tiny model's paged pool with two prefilled rows, and the operands
    of one decode step and one verify step over it."""
    params = llama.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    params = llama.from_numpy(llama.to_numpy(params), device)
    page, nb = 4, 8
    pool = gen.init_page_pool(cfg, 1 + 2 * nb, page, device=device)
    tables = torch.arange(1, 1 + 2 * nb, device=device).reshape(2, nb)
    rs = np.random.RandomState(seed)
    lens = (13, 6)
    for r, n in enumerate(lens):
        prompt = torch.tensor(rs.randint(0, cfg.vocab, (1, n)), device=device)
        gen.prefill_into_pages(params, prompt, n, pool, tables[r], 0, cfg, page)
    pos = torch.tensor(lens, device=device)
    tokens = torch.tensor(rs.randint(0, cfg.vocab, (2, 3)), device=device)
    return params, pool, tables, pos, tokens, page


def _steps(params, pool, tables, pos, tokens, cfg, page):
    pool = {k: v.clone() for k, v in pool.items()}
    d, _ = gen.decode_step(params, tokens[:, 0], pool, tables, pos, cfg, page)
    v, _ = gen.verify_step(params, tokens, pool, tables, pos + 1, cfg, page)
    return d, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_steps_equal_the_gather_path_bitwise(monkeypatch, dtype):
    cfg = dataclasses.replace(llama.tiny(vocab=64, dim=32), dtype=dtype)
    params, pool, tables, pos, tokens, page = _tiny_steps(cfg, "cpu")
    got = _steps(params, pool, tables, pos, tokens, cfg, page)
    monkeypatch.setattr(gen, "_paged_attention", _plain)
    want = _steps(params, pool, tables, pos, tokens, cfg, page)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_cpu_steps_launch_no_kernel():
    cfg = llama.tiny(vocab=64, dim=32)
    params, pool, tables, pos, tokens, page = _tiny_steps(cfg, "cpu")
    kernels.reset_launches()
    _steps(params, pool, tables, pos, tokens, cfg, page)
    assert kernels.LAUNCHES["paged_decode"] == 0


def test_wrapper_refuses_cpu_tensors():
    q, pk, pv, tables, pos = _case(0, 2, 1, 2, 2, 64, 16, 4, [3, 9], torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.paged_decode(q, pk, pv, tables, pos)
    assert kernels.LAUNCHES["paged_decode"] == 0


def test_launch_counts_and_routes():
    assert "paged_decode" in kernels.SOURCES and "paged_decode" in kernels.LAUNCHES
    assert set(kernels.ROUTES["paged_decode"]) == {"mma", "fma"}
    kernels.LAUNCHES["paged_decode"] = 5
    kernels.ROUTES["paged_decode"]["mma"] = 5
    kernels.reset_launches()
    assert kernels.LAUNCHES["paged_decode"] == 0 and kernels.ROUTES["paged_decode"]["mma"] == 0
    with pytest.raises(ValueError):
        kernels.kernel_info("paged_decode", "fma", 128)  # K1-K3's resources only


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 96, "fma"), (torch.bfloat16, 20, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 16, "fma")])
def test_route_rule_by_dtype_and_head_dim(dtype, hd, route):
    q, pk, pv, _, _ = _case(0, 2, 1, 2, 2, hd, 16, 4, [3, 9], dtype, "cpu")
    assert kernels.paged_route(q, pk, pv) == route


def test_route_rule_sends_unaligned_pools_to_fma():
    q, pk, pv, _, _ = _case(0, 2, 1, 2, 2, 128, 16, 4, [3, 9], torch.bfloat16, "cpu")
    flat = torch.zeros(pk.numel() + 1, dtype=pk.dtype)
    off = flat[1:].view(pk.shape)  # 2 bytes past an aligned start
    assert kernels.paged_route(q, off, pv) == "fma"
    assert kernels.paged_route(q, pk, pv) == "mma"


@pytest.mark.parametrize("route", ["mma", "fma"])
@pytest.mark.parametrize("b,kvh,rows,nb,page", [
    (32, 8, 4, 320, 16), (16, 8, 4, 528, 16), (1, 1, 1, 3, 4), (2, 2, 40, 16, 4),
    (8, 8, 20, 256, 16), (1, 8, 4, 20000, 1), (4, 2, 2, 17, 3)])
def test_split_rule_covers_every_live_length(b, kvh, rows, nb, page, route):
    """Every live length 1..S: the splits the card makes of it
    (``kernels.paged_row_split``) tile [0, live) in order, none empty, none
    past n_max, none with more pages than the shared table."""
    split = kernels.paged_decode_splits(b, kvh, rows, nb, page, 132, route)
    assert split.rc == (16 if route == "mma" else 4 if rows <= 4 else 8)
    chunks = -(-rows // split.rc)
    assert split.n_max >= 1
    assert b * kvh * chunks * split.n_max >= min(kernels.PAGED_BLOCKS_PER_SM * 132,
                                                 b * kvh * chunks * -(-nb * page // 128))
    assert split.tab_len <= kernels.PAGED_MAX_SPLIT_PAGES
    longest = 0
    for live in [*range(1, nb * page, max(1, nb * page // 997)), nb * page]:
        n, keys = kernels.paged_row_split(live, page, split.n_max, split.min_pages)
        assert 1 <= n <= split.n_max and keys % page == 0
        assert keys // page <= split.tab_len
        assert (n - 1) * keys < live <= n * keys  # the last split holds a key
        longest = max(longest, keys // page)
    assert longest == split.tab_len  # no shared memory sized for a split never made


def _plain_inverse_cdf(dist, uniforms):
    cdf = dist.cumsum(dim=-1)
    return ((cdf <= uniforms[:, None] * cdf[:, -1:]).sum(dim=-1)).clamp(max=dist.shape[-1] - 1)


@pytest.mark.parametrize("b", [1, 3])
def test_cpu_inverse_cdf_is_the_plain_cumsum(b):
    """On the CPU the two-row CDF of a batch-1 call is the one-row cumsum
    bit for bit: sampled streams there do not move."""
    g = torch.Generator().manual_seed(b)
    dist = torch.softmax(torch.randn(b, 5000, generator=g), -1)
    u = torch.rand(b, generator=g)
    assert torch.equal(gen.inverse_cdf(dist, u), _plain_inverse_cdf(dist, u))
    cdf = dist.cumsum(-1)
    edge = (cdf[:, 1234] - 1e-7) / cdf[:, -1]  # a draw at a cell's edge
    assert torch.equal(gen.inverse_cdf(dist, edge), _plain_inverse_cdf(dist, edge))


# -- the card ----------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("name,seed,b,t,g,kvh,hd,page,nb,pos,share,idle", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_path(name, seed, b, t, g, kvh, hd, page, nb, pos, share, idle,
                                   dtype):
    _card()
    q, pk, pv, tables, pos_t = _case(seed, b, t, g, kvh, hd, page, nb, pos, dtype, "cuda",
                                     share, idle)
    cfg = _attn_cfg(g * kvh, kvh, hd, dtype)
    kernels.reset_launches()
    got = kernels.paged_decode(q, pk, pv, tables, pos_t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 1
    assert kernels.ROUTES["paged_decode"][kernels.paged_route(q, pk, pv)] == 1
    want = _plain(q, pk, pv, tables, pos_t, cfg, page)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    tol = (F32_REL if dtype == torch.float32 else BF16_REL) * want.float().abs().max().item()
    assert err <= tol, f"{name} {dtype}: max err {err} > {tol}"


@pytest.mark.card
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_kernel_reads_no_key_past_the_position(dtype, route):
    """Poison every key and value past each row's last position (and the
    table entries past its last page): the output must not move."""
    _card()
    q, pk, pv, tables, pos = _case(12, 3, 2, 4, 2, 128, 16, 8, [17, 40, 100], dtype, "cuda")
    assert kernels.paged_route(q, pk, pv) == route
    want = kernels.paged_decode(q, pk, pv, tables, pos)
    pk2, pv2, tab2 = pk.clone(), pv.clone(), tables.clone()
    for r in range(3):
        last = int(pos[r]) + q.shape[1] - 1
        for s in range(last + 1, tables.shape[1] * 16):
            page = int(tables[r, s // 16])
            pk2[page, s % 16], pv2[page, s % 16] = float("nan"), float("nan")
        tab2[r, last // 16 + 1:] = 10 ** 9  # a read would fault
    got = kernels.paged_decode(q, pk2, pv2, tab2, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take():
    _card()
    q, pk, pv, tables, pos = _case(0, 2, 1, 2, 2, 64, 16, 4, [3, 9], torch.bfloat16, "cuda")
    bad = [
        (q.float(), pk, pv, tables, pos),                    # mixed dtypes
        (q, pk, pv, tables.int(), pos),                      # int32 table
        (q, pk, pv, tables, pos.int()),                      # int32 positions
        (q.transpose(1, 2), pk, pv, tables, pos),            # not contiguous
        (q[..., :32].contiguous(), pk, pv, tables, pos),     # head_dim mismatch
        (q[:, :, :3].contiguous(), pk, pv, tables, pos),     # 3 heads over 2 kv heads
        (q.half(), pk.half(), pv.half(), tables, pos),       # fp16
        (q, pk, pv, tables, pos.cpu()),                      # another device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernels.paged_decode(*args)


def _mistral4():
    return dataclasses.replace(llama.Config(), vocab=32768, n_layers=4, rope_theta=1e6,
                               max_seq=8192)


@pytest.mark.card
@pytest.mark.parametrize("which", ["tiny_f32", "tiny_bf16", "mistral4_bf16"])
def test_whole_steps_match_plain_path(monkeypatch, which):
    """decode_step and verify_step with the kernel against the same steps
    with the plain path, and no ``_gather`` on the kernel's side."""
    _card()
    if which == "mistral4_bf16":
        cfg = _mistral4()
        params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        page, nb, b = 16, 64, 8
        rs = np.random.RandomState(1)
        pool = gen.init_page_pool(cfg, 1 + b * nb, page, device="cuda")
        for x in pool.values():
            x.copy_(torch.randn(x.shape, device="cuda", dtype=torch.float32).to(x.dtype))
        tables = torch.tensor(1 + rs.permutation(b * nb).reshape(b, nb), device="cuda")
        tables[b - 1] = 0  # an idle row
        pos = torch.tensor([0, 15, 16, 200, 511, 777, 1023, nb * page], device="cuda")
        tokens = torch.tensor(rs.randint(0, cfg.vocab, (b, 5)), device="cuda")
    else:
        dtype = torch.float32 if which == "tiny_f32" else torch.bfloat16
        cfg = dataclasses.replace(llama.tiny(vocab=64, dim=64), dtype=dtype)
        params, pool, tables, pos, tokens, page = _tiny_steps(cfg, "cuda")

    def no_gather(*a, **k):
        raise AssertionError("the kernel's steps gathered a page table")

    with monkeypatch.context() as m:
        m.setattr(gen, "_gather", no_gather)
        kernels.reset_launches()
        got = _steps(params, pool, tables, pos, tokens, cfg, page)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["paged_decode"] == 2 * cfg.n_layers
    monkeypatch.setattr(gen, "_paged_attention", _plain)
    want = _steps(params, pool, tables, pos, tokens, cfg, page)
    # The verify's rows past the table write scratch page 0 in one
    # index_put_, and CUDA fixes no winner among duplicate indices: the
    # idle row, which reads only page 0, is compared in the decode alone
    # (the engine discards its output).
    live = (pos + tokens.shape[1] < tables.shape[1] * page) | (tables != 0).any(dim=1)
    for a, w, rows in zip(got, want, (slice(None), live)):
        assert torch.isfinite(a).all()
        err = (a[rows] - w[rows]).abs().max().item()
        tol = LOGIT_REL[cfg.dtype] * w[rows].abs().max().item()
        assert err <= tol, f"{which}: logits differ by {err} > {tol}"


@pytest.mark.card
def test_engine_greedy_streams_match_plain_path(monkeypatch):
    """ServeEngine on the card, plain and speculative, with the kernel and
    with the plain path: the same greedy streams; one paged-decode launch
    a layer a decode step."""
    _card()
    from oim_tpu_torch.serve import ServeEngine

    cfg = llama.tiny(vocab=64, dim=64)
    params = llama.from_numpy(
        llama.to_numpy(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu")), "cuda")
    rs = np.random.RandomState(3)
    reqs = [(rs.randint(0, cfg.vocab, n).tolist(), 12) for n in (3, 17, 1, 30, 9)]

    def streams(**kw):
        eng = ServeEngine(params, cfg, max_batch=4, max_seq=64, device="cuda", **kw)
        try:
            handles = [eng.submit(p, max_new=n) for p, n in reqs]
            outs = [h.result(timeout=120) for h in handles]
            return outs, eng.stats()
        finally:
            eng.stop()

    kernels.reset_launches()
    got, st = streams()
    assert kernels.LAUNCHES["paged_decode"] == cfg.n_layers * st["target_steps"]
    spec, _ = streams(draft_params=params, draft_cfg=cfg, spec_tokens=3)
    monkeypatch.setattr(gen, "_paged_attention", _plain)
    kernels.reset_launches()
    want, _ = streams()
    assert kernels.LAUNCHES["paged_decode"] == 0
    assert got == want and spec == want


@pytest.mark.card
def test_batch1_sampling_repeats_on_the_card():
    """A batch-1 draw at a cell's edge returns the same index every call:
    a batch-1 engine's sampled streams equal across replicas. (CUDA's
    one-row cumsum gave 235 distinct sums in 300 calls.)"""
    _card()
    g = torch.Generator(device="cuda").manual_seed(7)
    dist = torch.softmax(torch.randn(1, 128256, device="cuda", generator=g) / 0.8, -1)
    cdf = dist.expand(2, -1).cumsum(-1)[0]
    cells = torch.arange(1000, 128000, 2000, device="cuda")
    edges = cdf[cells] / cdf[-1]  # draws on the cells' edges: the last bit of the CDF decides
    want = [gen.inverse_cdf(dist, e[None]) for e in edges]
    for _ in range(20):
        assert all(torch.equal(gen.inverse_cdf(dist, e[None]), w) for e, w in zip(edges, want))

