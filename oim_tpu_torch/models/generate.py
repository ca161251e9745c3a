"""Autoregressive decoding for the Llama family (``oim_tpu/models/generate.py``):
a KV cache, the paged serving steps, and greedy or sampled generation.

The JAX package scans the stacked layers inside jit and threads the cache
through as a value; here the layers are a Python loop over the same
stacked [L, ...] params and the caches are updated IN PLACE (``index_put_``
on each layer's slice, the counterpart of the JAX engine's donated
buffers). Every function still returns the cache or pool it was given, so
call sites read as in the JAX package.

Numerics follow the reference: the attention products take bf16 (or f32)
operands and accumulate AND return f32 (the reference's
``preferred_element_type=jnp.float32``; the operands are upcast, which is
exact), masked scores are -inf on ABSOLUTE positions (``pos + t >= s``,
never SDPA's top-left ``is_causal``), and the probabilities drop to the
cache dtype before the PV product.

Which path the paged steps' attention takes depends on the pool's device
(``_paged_attention``): ``decode_step`` and ``verify_step`` on a CUDA pool
call the Hopper paged-decode kernel (``kernels.paged_decode``), which reads
each row's live pages in place through its page table with the same
numerics; a CPU pool gathers each row's whole table (``_gather``) for
``_cache_attention``, as the reference does. Prefill and the dense cache
keep ``_cache_attention`` on every device.

Out-of-range indices clamp in JAX and raise in torch, so the port clamps
where the reference relies on it: the RoPE table index clamps to S-1
(only rows whose output is discarded ever reach it: an idle serving row at
``max_seq``, a verify window running past the table). Writes the reference
drops (``mode="drop"``) are sliced away on the host in
``prefill_into_pages`` (``n_tokens`` and ``start`` are host ints there)
and routed to scratch page 0, garbage by design, in ``verify_step``.

Sampling draws uniforms from one ``torch.Generator`` per request: one draw
after the prefill, one per decode step (``sample``), so a request's
stream does not depend on its batch-mates. The streams cannot equal the
reference's threefry chains; greedy streams equal the reference's token
for token.

MoE configs decode with no drops (``_no_drop``: capacity == tokens of
the call), so routing is per token and a row's logits do not depend on
its batch-mates; every expert runs on every token's slot, E x N expert
rows for N tokens, as in the reference.

Tensor-parallel decode (``axis``, a ``serve.shard.MemberGroup``): each
member runs these functions on its Megatron slices of the weights and its
KV heads of the pool, with ``shard_config``'s member-local cfg; ``_reduce``
after wo and after w_down is the only point where members meet. The
partial products there are taken in f32 and their sum is rounded once to
the model dtype, as the unsharded product rounds its f32 accumulator
once (the reference sums the rounded partials; in f32 the two agree). In
bf16 the sharded products still sum in other orders than the whole ones,
so a greedy stream may part from one member's after some tokens where
two logits nearly tie.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from oim_tpu_torch import kernels
from oim_tpu_torch.models.llama import Config, _ffn, check_supported, layer_params
from oim_tpu_torch.ops.norms import rmsnorm
from oim_tpu_torch.ops.rope import apply_rope, rope_frequencies


def shard_config(cfg: Config, n: int) -> Config:
    """The PER-MEMBER view of ``cfg`` on an ``n``-way tensor-parallel
    mesh: 1/n of the query and KV heads (the GQA group size is kept, so
    contiguous head slices keep every query head beside its KV head)."""
    if n < 1:
        raise ValueError(f"shard count must be >= 1, got {n}")
    if n == 1:
        return cfg
    if cfg.n_experts:
        raise ValueError(
            "tensor-parallel decode does not support MoE configs yet "
            f"(n_experts={cfg.n_experts})")
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(
            f"shard count {n} must divide n_heads ({cfg.n_heads}) and "
            f"n_kv_heads ({cfg.n_kv_heads})")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n)


def _no_drop(cfg: Config) -> Config:
    """MoE inference must not drop tokens: a capacity factor of
    n_experts/top_k makes capacity == n_tokens."""
    if not cfg.n_experts:
        return cfg
    factor = cfg.n_experts / cfg.moe_top_k
    if cfg.moe_capacity_factor >= factor:
        return cfg
    return dataclasses.replace(cfg, moe_capacity_factor=factor)


def _check(cfg: Config, axis) -> Config:
    if axis is not None and cfg.n_experts:
        raise ValueError(
            "tensor-parallel decode does not support MoE configs yet "
            f"(n_experts={cfg.n_experts})")
    check_supported(cfg)
    return _no_drop(cfg)


def _partial(a, w):
    """``a @ w`` with an f32 result: one member's share of a row-split
    product. bf16/fp16 CUDA operands go through cuBLAS's f32-output GEMM;
    elsewhere the operands are upcast (exact)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return a.float() @ w.float()


def _reduce(x, axis):
    """Sum a partial projection product over the members (no-op when
    unsharded). With wq/wk/wv column-split and wo/w_down row-split, every
    other tensor of a layer is either member-local (per-head attention,
    the gated MLP halves) or replicated (the residual stream), so one sum
    after the attention-out projection and one after the FFN-down
    projection reassemble the unsharded products."""
    if axis is None:
        return x
    return axis.allreduce(x)


def _project(a, w, axis):
    """``a @ w`` in ``a``'s dtype; under ``axis`` the members' f32
    partials summed and rounded once."""
    if axis is None:
        return a @ w
    return _reduce(_partial(a, w), axis).to(a.dtype)


def init_cache(cfg: Config, batch: int, max_seq: int, device="cuda"):
    """Zeroed KV cache: {"k","v"} of [L, B, max_seq, kv_heads, head_dim]."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _cache_attention(q, ck, cv, pos, cfg: Config):
    """q [B,T,H,hd] over the full cache [B,S,kvh,hd], masked to positions
    <= pos+t. ``pos`` is an int (every row at one depth) or a [B] tensor
    (the serving batch, every slot at its own depth).

    GQA is a grouped product against the kv-head cache: no head-expanded
    copy. Scores and the PV sums are f32 from the cache-dtype operands;
    the probabilities drop to the cache dtype before PV."""
    B, T, H, hd = q.shape
    S = ck.shape[1]
    kvh = cfg.n_kv_heads
    g = H // kvh
    # [B, kvh, g*T, hd] x [B, kvh, hd, S] -> [B, kvh, g*T, S]
    qg = q.reshape(B, T, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(B, kvh, g * T, hd)
    scores = torch.matmul(qg.float(), ck.permute(0, 2, 3, 1).float()) * (hd ** -0.5)
    scores = scores.view(B, kvh, g, T, S)
    t = torch.arange(T, device=q.device)
    s = torch.arange(S, device=q.device)
    q_pos = (t + pos).expand(B, T) if isinstance(pos, int) else pos[:, None] + t
    mask = q_pos[:, :, None] >= s  # [B, T, S]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.matmul(probs.view(B, kvh, g * T, S).float(),
                       cv.permute(0, 2, 1, 3).float())  # [B, kvh, g*T, hd]
    out = out.view(B, kvh, g, T, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H, hd).to(q.dtype)


def _block(x, layer, cfg: Config, cos, sin, positions, attend, axis=None):
    """One decoder layer around the cache: ``attend(q, k, v)`` writes this
    step's K/V and returns the queries' attention over the cache."""
    B, T, _ = x.shape
    h = rmsnorm(x, layer["attn_norm"])
    q = (h @ layer["wq"]).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = (h @ layer["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ layer["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = attend(q, k, v)
    x = x + _project(attn.reshape(B, T, cfg.q_dim), layer["wo"], axis)
    h = rmsnorm(x, layer["mlp_norm"])
    if axis is None:
        ffn, _ = _ffn(h, layer, cfg)
    else:
        ffn = _project(F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"]), layer["w_down"],
                       axis)
    return x + ffn


def _embed(params, tokens, cfg: Config):
    return F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)


def _rope_positions(positions, S: int):
    """The RoPE table index, clamped where JAX's gather clamps."""
    return positions.clamp(max=S - 1)


@torch.no_grad()
def cached_forward(params, tokens, cache, pos: int, cfg: Config, axis=None):
    """Forward ``tokens`` [B,T] at absolute positions pos..pos+T-1, writing
    their K/V into ``cache`` in place. Returns (logits [B,T,vocab] f32,
    cache). Serves prefill (T = prompt length, pos = 0) and decode
    (T = 1). Under ``axis`` (a member group) ``params``, ``cache`` and
    ``cfg`` are the calling member's (see the module docstring)."""
    cfg = _check(cfg, axis)
    B, T = tokens.shape
    S = cache["k"].shape[2]
    dev = tokens.device
    pos = int(pos)
    start = min(max(pos, 0), S - T)  # where dynamic_update_slice writes
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, device=dev)
    positions = _rope_positions(
        (pos + torch.arange(T, device=dev)).expand(B, T), S)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv):
            ck[:, start:start + T] = k
            cv[:, start:start + T] = v
            return _cache_attention(q, ck, cv, pos, cfg)

        x = _block(x, layer_params(params["layers"], i), cfg, cos, sin, positions, attend,
                   axis)
    x = rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float(), cache


# -- serving entry points (oim_tpu_torch/serve: continuous batching) ------
#
# The serving engine's KV storage is PAGED: one pool {"k","v"} [L, n_pages,
# page_tokens, kv_heads, head_dim] shared by every live request, addressed
# through per-slot page tables (logical position s of slot b lives at
# pool[:, table[b, s // page], s % page]). A step scatters this step's K/V
# through the table, then attends the slot's logical [S] cache
# (``_paged_attention``). On a CUDA pool the decode and verify steps read
# each row's live pages in place with the paged-decode kernel; on the CPU,
# and in prefill everywhere, they gather the slot's whole table for the
# SAME ``_cache_attention`` the solo path uses. Masked positions (unwritten
# pads, stale bytes in a reused page, scratch page 0) weigh exactly zero
# (-inf score -> 0 probability), so paged and dense attention sum the same
# terms.


def init_page_pool(cfg: Config, n_pages: int, page_tokens: int, device="cuda"):
    """Zeroed page pool: {"k","v"} of [L, n_pages, page_tokens, kv_heads,
    head_dim]. Physical page 0 is the engine's scratch page: unmapped
    table entries point at it and discarded writes land in it."""
    shape = (cfg.n_layers, n_pages, page_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _gather(pages, table, S: int):
    """The logical [B, S, kvh, hd] cache view of ``table`` [B, n_blocks]."""
    B = table.shape[0]
    return pages[table].reshape(B, S, *pages.shape[2:])


def _paged_attention(q, pk, pv, tables, pos, cfg: Config, page_tokens: int):
    """q [B, T, H, hd] over each row's pages of one layer's pool ``pk``/
    ``pv`` through ``tables`` [B, n_blocks] (int64), query t of row b at
    position ``pos[b] + t``. A CUDA pool goes to the paged-decode kernel,
    which reads the live pages in place (it raises on what it does not
    take); a CPU pool to ``_gather`` and ``_cache_attention``."""
    if pk.is_cuda:
        return kernels.paged_decode(q.contiguous(), pk, pv, tables, pos)
    S = tables.shape[1] * page_tokens
    return _cache_attention(q, _gather(pk, tables, S), _gather(pv, tables, S), pos, cfg)


@torch.no_grad()
def prefill_into_pages(params, tokens, n_tokens: int, pool, page_table,
                       start: int, cfg: Config, page_tokens: int, axis=None):
    """Prefill ``tokens`` [1, T] (the first ``n_tokens`` real, the rest
    pad) through ``page_table`` [n_blocks] into the pool, at logical
    positions [start, start + n_tokens). ``n_tokens`` and ``start`` are
    host ints. Returns (the last real token's logits [vocab] f32, pool).

    One function serves both prefill paths: the full prompt at start=0,
    and a prefix-cache hit, where ``tokens`` is the uncached tail and the
    table already references the store's pages, read in place. Pad
    positions and positions past the table are never written (the
    reference drops them at the scatter), which keeps shared pages
    immutable."""
    cfg = _check(cfg, axis)
    B, T = tokens.shape  # B == 1: admission is per slot
    n_tokens, start = int(n_tokens), int(start)
    nb = page_table.shape[0]
    S = nb * page_tokens
    dev = tokens.device
    page_table = page_table.long()
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, device=dev)
    logical = start + torch.arange(T, device=dev)
    positions = _rope_positions(logical.expand(B, T), S)
    keep = max(0, min(n_tokens, S - start, T))  # written positions: t < keep
    phys = page_table[torch.clamp(logical[:keep] // page_tokens, max=nb - 1)]
    off = logical[:keep] % page_tokens
    table = page_table[None]
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        pk, pv = pool["k"][i], pool["v"][i]

        def attend(q, k, v, pk=pk, pv=pv):
            pk.index_put_((phys, off), k[0, :keep])
            pv.index_put_((phys, off), v[0, :keep])
            return _cache_attention(q, _gather(pk, table, S), _gather(pv, table, S), start, cfg)

        x = _block(x, layer_params(params["layers"], i), cfg, cos, sin, positions, attend,
                   axis)
    last = rmsnorm(x[:, n_tokens - 1], params["final_norm"])
    return (last @ params["lm_head"]).float()[0], pool


@torch.no_grad()
def decode_step(params, tokens, pool, page_tables, pos, cfg: Config,
                page_tokens: int, axis=None):
    """One lockstep decode step over the slot batch: ``tokens`` [B] (each
    slot's previous token) at absolute positions ``pos`` [B], written and
    attended through ``page_tables`` [B, n_blocks]. Returns (logits
    [B, vocab] f32, pool).

    Positions past the table (an idle row clamped at max_seq, a draft
    proposing past a request's end) write scratch page 0, never the
    clamped last page, which a live row may own; an idle row's all-zero
    table routes its in-range writes to page 0 too."""
    cfg = _check(cfg, axis)
    B = tokens.shape[0]
    nb = page_tables.shape[1]
    S = nb * page_tokens
    dev = tokens.device
    page_tables = page_tables.long().contiguous()
    pos = pos.long().contiguous()
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, device=dev)
    positions = _rope_positions(pos[:, None], S)
    rows = torch.arange(B, device=dev)
    blk = torch.clamp(pos // page_tokens, max=nb - 1)
    phys = torch.where(pos < S, page_tables[rows, blk], 0)
    off = pos % page_tokens
    x = _embed(params, tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        pk, pv = pool["k"][i], pool["v"][i]

        def attend(q, k, v, pk=pk, pv=pv):
            pk.index_put_((phys, off), k[:, 0])
            pv.index_put_((phys, off), v[:, 0])
            return _paged_attention(q, pk, pv, page_tables, pos, cfg, page_tokens)

        x = _block(x, layer_params(params["layers"], i), cfg, cos, sin, positions, attend,
                   axis)
    x = rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float()[:, 0], pool


@torch.no_grad()
def verify_step(params, tokens, pool, page_tables, pos, cfg: Config,
                page_tokens: int, axis=None):
    """The multi-token sibling of ``decode_step``: forward ``tokens``
    [B, T] (each row's previous token and T-1 speculated candidates) at
    positions pos..pos+T-1 (``pos`` [B]). Returns (logits [B, T, vocab]
    f32, pool): the logits T single-token decode steps would give.

    Positions past the table, which the reference drops, write scratch
    page 0 here (its content is garbage by design), as do a row's
    unmapped table entries: a verify never writes a page it does not own.
    K/V of rejected candidates stays in place, logically dead: the next
    round overwrites it before any gather, and ``pos`` masks the rest."""
    cfg = _check(cfg, axis)
    B, T = tokens.shape
    nb = page_tables.shape[1]
    S = nb * page_tokens
    dev = tokens.device
    page_tables = page_tables.long().contiguous()
    pos = pos.long().contiguous()
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, device=dev)
    logical = pos[:, None] + torch.arange(T, device=dev)  # [B, T]
    positions = _rope_positions(logical, S)
    rows = torch.arange(B, device=dev)[:, None]
    blk = torch.clamp(logical // page_tokens, max=nb - 1)
    phys = torch.where(logical < S, page_tables[rows, blk], 0)
    off = logical % page_tokens
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        pk, pv = pool["k"][i], pool["v"][i]

        def attend(q, k, v, pk=pk, pv=pv):
            pk.index_put_((phys, off), k)
            pv.index_put_((phys, off), v)
            return _paged_attention(q, pk, pv, page_tables, pos, cfg, page_tokens)

        x = _block(x, layer_params(params["layers"], i), cfg, cos, sin, positions, attend,
                   axis)
    x = rmsnorm(x, params["final_norm"])
    return (x @ params["lm_head"]).float(), pool


def inverse_cdf(dist, uniforms):
    """The index each row of ``dist`` [B, V] (nonnegative, any scale)
    yields at its U[0,1) draw in ``uniforms`` [B]: the first i with
    u * total < cdf[i], so an index of zero mass is never picked.

    The CDF is taken over at least two rows: CUDA's cumsum of a single
    row is one device-wide scan whose float sums change from call to call
    (235 distinct results in 300 calls on an H100), so a batch-1 engine's
    sampled streams could part between replicas where a draw falls at a
    cell's edge; two or more rows are scanned one block a row, the same
    bits every call (and on the CPU a row's sums are the same either way)."""
    cdf = (dist.expand(2, -1) if dist.shape[0] == 1 else dist).cumsum(dim=-1)[:dist.shape[0]]
    idx = (cdf <= uniforms[:, None] * cdf[:, -1:]).sum(dim=-1)
    return idx.clamp(max=dist.shape[-1] - 1)


def sample(logits, temps, uniforms):
    """Next tokens from ``logits`` [B, V] f32: argmax where ``temps`` [B]
    is 0, else drawn from softmax(logits / temp) at ``uniforms`` [B] (one
    draw per sampled row from its request's generator; ignored on greedy
    rows). Returns [B] int64."""
    greedy = logits.argmax(dim=-1)
    safe = torch.where(temps > 0, temps, torch.ones_like(temps))
    sampled = inverse_cdf(torch.softmax(logits / safe[:, None], dim=-1), uniforms)
    return torch.where(temps > 0, sampled, greedy)


@torch.no_grad()
def generate(params, prompt, n_new: int, cfg: Config,
             temperature: float = 0.0, rng: torch.Generator | None = None,
             max_seq: int | None = None):
    """prompt [B,T0] int -> [B, T0+n_new]: prefill once, then one decode
    step per token on a dense cache. temperature 0 = greedy, else
    sampling with ``rng`` (default: a generator seeded 0 on the prompt's
    device), one [B] draw after the prefill and one per step."""
    B, t0 = prompt.shape
    if n_new < 0:
        raise ValueError(f"n_new must be >= 0, got {n_new}")
    if n_new == 0:
        return prompt
    s = max_seq or (t0 + n_new)
    if s < t0 + n_new:
        raise ValueError(f"max_seq {s} < prompt {t0} + n_new {n_new}")
    cfg = _check(cfg, None)
    dev = prompt.device
    if temperature > 0 and rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    temps = torch.full((B,), float(temperature), dtype=torch.float32, device=dev)

    def pick(logits):
        u = (torch.rand(B, generator=rng, device=dev) if temperature > 0
             else torch.zeros(B, device=dev))
        return sample(logits, temps, u)

    cache = init_cache(cfg, B, s, device=dev)
    logits, cache = cached_forward(params, prompt, cache, 0, cfg)
    out = [pick(logits[:, -1])]
    for pos in range(t0, t0 + n_new - 1):
        logits, cache = cached_forward(params, out[-1][:, None], cache, pos, cfg)
        out.append(pick(logits[:, -1]))
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)
