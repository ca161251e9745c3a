"""Continuous-batching decode engine (``oim_tpu/serve/engine.py``): the
serving tier's scheduler.

KV storage is a PAGED POOL (``serve/pagepool.py``): one [L, n_pages,
page_tokens] device pool shared by every live request, addressed through
per-slot page tables. Admission reserves only the pages a request can use,
ceil((prompt + max_new - 1) / page_tokens); when the pool cannot cover the
next admission, the request WAITS at the head of the bounded queue until
retirements return pages (backpressure, never an out-of-memory error).

A request is admitted into a free batch row MID-FLIGHT: its prefill
(``models/generate.py prefill_into_pages``, batch 1, writing through the
slot's page table) runs between decode steps of the residents, then the
whole batch advances in lockstep through ONE decode step
(``decode_step``, per-row positions and page tables). Retirement is per
slot: an EOS token, the request's max-tokens budget or a cancel returns
the slot's pages.

Prompt-prefix KV reuse (``serve/prefixcache.py``): a retiring slot donates
its prompt's full-block pages to a content-addressed store by REFERENCE;
an admission that matches m blocks writes the store's page ids into its
own table and prefills only the tail. With ``kv_host_bytes`` an evicted
store-only page is copied to a host-RAM LRU (``serve/kvtier.py``) and a
later hit copies it back into a fresh page.

The fleet tier (``serve/kvvolume.py``): with a ``kv_fetch`` callback, an
admission whose chain the store and the host tier do not cover asks it for
the rest, and writes the consecutive blocks it returns into fresh pages in
one batch (``kvtier.stage_pages``); any failure recomputes locally and
emits ``kv_fetch_fallback``. ``snapshot_chain`` reads a cached chain's
pages for an export, through the command queue (``_call_on_engine``) when
called from another thread. The roles: ``prefill`` advertises its block
in ``stats()`` even while cold, and with ``set_handoff_export`` each
retirement (not a cancel) exports the prompt's chain before the stream
closes; ``decode`` and ``mixed`` change only what ``stats()`` advertises.

Speculative decoding (``serve/spec.py``): with a draft model, a decode
round is draft-propose (K+1 draft ``decode_step``s over the draft's own
page pool) plus target-verify (ONE ``verify_step`` over the K proposals)
plus acceptance; each slot advances 1..K+1 tokens per target forward. An
adaptive valve drops to plain decode when acceptance stops paying.

What the port keeps of the reference, and what it changes:
* The device programs are plain functions (``decode_program``,
  ``prefill_program``, ``propose_program``, ``verify_program``; the
  draft's prefill is ``prefill_into_pages`` itself); the pools are updated in place, the counterpart of
  the reference's donated buffers. Step operands stay on the device
  between steps: one [B] token fetch per step is the only sync.
* Randomness is one ``torch.Generator`` per sampled request on the
  engine's device, seeded with the request's seed: one draw after the
  prefill and one per decode step, exactly as ``generate()`` draws, so a
  request's stream does not depend on its batch-mates and equals solo
  ``generate()`` given the same logits. A speculating engine's sampled
  rows draw K+1 uniforms a round instead (``spec.accept_tokens``): their
  streams are distribution-exact, not solo reproductions.
* The engine thread runs under ``torch.inference_mode()``.
* Observability is the reference's: the ``oim_serve_*`` metrics with
  their label values (token latency and first-token histograms carry the
  request's trace_id as an exemplar), the ``serve.prefill`` and
  ``serve.draft_prefill`` spans, the ``serve.queue_wait`` and
  ``serve.decode`` phase spans recorded at retirement, the flight
  recorder's slot_evicted, page_pool_exhausted, spec_fallback,
  kv_peer_fetch, kv_fetch_fallback and replica_drain events, and the
  fault points ``serve.admit``,
  ``spec.propose``, ``serve.retire`` and ``serve.decode``. Every metric
  reads a value the host already holds: recording adds no device sync.
* The engine thread's loop on the device trace (``tracing.device_range``,
  ranges only while a torch profiler records), one range after another:
  ``serve.admit`` (an admission pass, its prefills inside),
  ``serve.decode_step`` (operands, the device program, the token fetch)
  and ``serve.emit`` (the host turn after a fetch or a pass: emission,
  retirement, the loop's way back). ``request_stats()`` counts, from
  host-held values, the live rows' keys over target steps
  (``decode_kv_tokens``), the host turns outside admission passes
  (``decode_host_seconds``) and the admissions that held resident rows
  (``prefill_stall_seconds``).
* Tensor-parallel serving (``shard > 1``, ``serve/shard.py``): the target
  programs (prefill, decode, the spec verify) run on ``shard`` members,
  each holding its Megatron slice of the weights and its KV heads of the
  pool on ``devices[k]``; page tables, sampling and the draft stay on the
  engine's device. ``member_hbm_budget`` refuses a model whose member
  share does not fit, ``set_member_watch`` folds the members' liveness
  into ``stats()``' readiness, and one allreduce probe a target dispatch
  feeds ``oim_serve_ici_allreduce_seconds``.
* The snapshot's and the adoption's pages of a sharded replica go
  through ``serve/shard.py`` (``pool_page_kv``, ``stage_pool_pages``), each
  member its KV heads, so a chain's blob holds whole pages at any shard
  count.

Invariants (``tests/test_torch_serve.py``): greedy streams equal solo
``generate()``; a retired slot leaks nothing into its next occupant; a
full admission queue refuses (``QueueFull``) and an exhausted pool queues;
cancel evicts the slot at the next step boundary and ``stop(drain=True)``
finishes residents, fails the queue as "drained", and leaks no page.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import traceback
from typing import Any

import numpy as np
import torch

from oim_tpu_torch.common import events, faultinject, prefixhash, tracing
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.models import generate as gen
from oim_tpu_torch.models.llama import Config, check_supported
from oim_tpu_torch.serve.kvtier import HostTier, host_dtype, page_kv, stage_page, stage_pages
from oim_tpu_torch.serve.pagepool import PagePool
from oim_tpu_torch.serve import shard as shardlib
from oim_tpu_torch.serve.prefixcache import PrefixStore
from oim_tpu_torch.serve.spec import DRAFT_KEY_FOLD, AcceptanceValve, accept_tokens


class QueueFull(Exception):
    """The bounded admission queue is full: backpressure, never silent
    queueing."""


class Draining(Exception):
    """The engine is draining/stopped and admits nothing new."""


_DONE = object()  # sentinel closing a request's token stream


@dataclasses.dataclass
class _Request:
    prompt: list[int]
    max_new: int
    temperature: float
    seed: int
    eos: int
    out: "queue.Queue[Any]" = dataclasses.field(
        default_factory=lambda: queue.Queue())
    cancelled: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    finish_reason: str = ""
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    emitted: int = 0
    # Host clock at each emitted token (first-token and inter-token
    # latency, where the reference observes its histograms).
    token_times: list[float] = dataclasses.field(default_factory=list)
    # Prompt tokens whose K/V came from the prefix cache (0 = the whole
    # prompt was prefilled): the per-request hit record.
    prefix_tokens: int = 0
    # The submitter's span context: the request's spans parent under it
    # and its trace_id rides the latency buckets as an exemplar.
    trace_ctx: Any = None


class GenHandle:
    """Caller-side view of one submitted request: a token stream, a cancel
    switch, and its post-mortem stats."""

    def __init__(self, req: _Request):
        self._req = req

    def tokens(self, timeout: float | None = None):
        """Yield token ids as the batch produces them; returns when the
        request finishes (see ``finish_reason``). ``timeout`` bounds the
        wait for EACH token, raising ``queue.Empty`` when it lapses."""
        while True:
            item = self._req.out.get(timeout=timeout)
            if item is _DONE:
                return
            yield item

    def result(self, timeout: float | None = None) -> list[int]:
        return list(self.tokens(timeout=timeout))

    def cancel(self) -> None:
        """Ask the engine to evict this request's slot at the next step
        boundary (idempotent; also unblocks a queued request)."""
        self._req.cancelled.set()

    @property
    def finish_reason(self) -> str:
        return self._req.finish_reason

    @property
    def stats(self) -> dict:
        r = self._req
        times = list(r.token_times)
        return {
            "queue_wait_s": max(r.admitted_at - r.submitted_at, 0.0)
            if r.admitted_at else 0.0,
            "tokens": r.emitted,
            "finish_reason": r.finish_reason,
            "prefix_tokens": r.prefix_tokens,
            "first_token_s": times[0] - r.submitted_at if times else None,
            "inter_token_s": [b - a for a, b in zip(times, times[1:])],
        }


# -- the device programs (the reference's _target_programs and
# _spec_programs, as plain functions) --------------------------------------


def target_forwards(cfg: Config, page: int, group=None):
    """The target model's three forwards with the unsharded signatures,
    (decode, prefill, verify): ``decode(params, tokens, pool, tables,
    pos)``, ``prefill(params, tokens, n_tokens, pool, table, start)``,
    ``verify(params, tokens, pool, tables, pos)``, each returning (logits,
    pool). With a member ``group`` (``serve/shard.py``) they run on every
    member with the member-local cfg: ``params`` and ``pool`` are then the
    lists of member trees and pools, and the logits member 0's."""
    if group is None:
        return (lambda p, t, c, tb, ps: gen.decode_step(p, t, c, tb, ps, cfg, page),
                lambda p, t, n, c, tb, st: gen.prefill_into_pages(p, t, n, c, tb, st, cfg,
                                                                  page),
                lambda p, t, c, tb, ps: gen.verify_step(p, t, c, tb, ps, cfg, page))
    lcfg = gen.shard_config(cfg, group.size)
    return (shardlib.wrap_forward(group, lambda p, t, c, tb, ps: gen.decode_step(
                p, t, c, tb, ps, lcfg, page, axis=group), cache_arg=1),
            shardlib.wrap_forward(group, lambda p, t, n, c, tb, st: gen.prefill_into_pages(
                p, t, n, c, tb, st, lcfg, page, axis=group), cache_arg=2),
            shardlib.wrap_forward(group, lambda p, t, c, tb, ps: gen.verify_step(
                p, t, c, tb, ps, lcfg, page, axis=group), cache_arg=1))


def decode_program(forward, params, pool, tokens, pos, temps, uniforms, tables,
                   max_seq: int):
    """One lockstep decode step with sampling through ``forward``
    (``target_forwards``' decode). Returns the step's next operands:
    (tokens [B], positions [B]). Positions advance for every row; idle
    rows' positions clamp at ``max_seq`` (a live row retires before it
    could reach the clamp)."""
    logits, _ = forward(params, tokens, pool, tables, pos)
    return (gen.sample(logits.to(tokens.device), temps, uniforms),
            torch.clamp(pos + 1, max=max_seq))


def prefill_program(forward, params, pool, tokens, n_tokens: int, table, start: int,
                    temp, uniform):
    """A slot's prefill through ``forward`` (``target_forwards``' prefill:
    the whole prompt, or the tail after a prefix hit) and the first token
    sampled from its last position. Returns [1]."""
    last, _ = forward(params, tokens, n_tokens, pool, table, start)
    return gen.sample(last.to(tokens.device)[None], temp, uniform)


def propose_program(dparams, dpool, tokens, pos, temps, uniforms, tables,
                    dcfg: Config, page: int, max_seq: int, K: int):
    """K+1 draft decode steps: each feeds the previous token, writes its
    K/V through the draft tables and samples the next proposal with
    ``uniforms[:, i]`` (the draft generators' draws). The EXTRA step
    ingests the last proposal so its K/V lands at pos+K: after an
    all-accept round the next round starts at pos+K+1 and would otherwise
    leave a hole in the draft's context. Returns (proposals [B, K], their
    draft logits [B, K, V])."""
    toks, logits = [], []
    tok = tokens
    for i in range(K + 1):
        lg, _ = gen.decode_step(dparams, tok, dpool, tables, pos, dcfg, page)
        tok = gen.sample(lg, temps, uniforms[:, i])
        pos = torch.clamp(pos + 1, max=max_seq)
        if i < K:
            toks.append(tok)
            logits.append(lg)
    return torch.stack(toks, dim=1), torch.stack(logits, dim=1)


def verify_program(forward, params, pool, tokens, pos, temps, uniforms, tables,
                   draft_toks, draft_logits, spec_mask, max_seq: int):
    """The target's verify forward (``target_forwards``' verify) and the
    acceptance. Returns (out [B, K+1], n_emit [B], the last emitted token
    [B], positions [B]): the device state advances past every emitted
    token (a row the host truncates retires)."""
    seq = torch.cat([tokens[:, None], draft_toks], dim=1)  # [B, K+1]
    logits, _ = forward(params, seq, pool, tables, pos)
    logits = logits.to(tokens.device)
    out, n_emit = accept_tokens(logits, draft_toks, draft_logits, temps,
                                uniforms, spec_mask)
    rows = torch.arange(out.shape[0], device=out.device)
    return out, n_emit, out[rows, n_emit - 1], torch.clamp(pos + n_emit, max=max_seq)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & (2 ** 63 - 1))


class ServeEngine:
    # Smallest prefill bucket: prompts are padded up to the next power of
    # two >= this (pad K/V never lands: prefill_into_pages skips the pad
    # positions).
    MIN_PREFILL_BUCKET = 8
    # Sliding window of the oim_serve_qps gauge.
    QPS_WINDOW_S = 10.0
    # How many hot chain hashes the serve row advertises for the router's
    # prefix-affinity pick (serve/registration.py).
    ADVERTISE_PREFIXES = 16

    def __init__(
        self,
        params,
        cfg: Config,
        max_batch: int = 8,
        max_seq: int = 256,
        queue_depth: int = 64,
        default_max_new: int = 64,
        prefix_cache_bytes: int = 64 << 20,
        prefix_block: int = 16,
        kv_page_tokens: int = 0,
        kv_pool_tokens: int = 0,
        kv_host_bytes: int = 0,
        kv_fetch=None,
        draft_params=None,
        draft_cfg: Config | None = None,
        spec_tokens: int = 0,
        spec_pool_tokens: int = 0,
        spec_accept_floor: float = 0.3,
        spec_window_rounds: int = 64,
        spec_reprobe_rounds: int = 256,
        shard: int = 1,
        member_hbm_budget: int = 0,
        role: str = "mixed",
        prefill_chunk: int = 0,
        name: str = "",
        device="cuda",
        devices=None,
    ):
        check_supported(cfg)
        if draft_cfg is not None:
            check_supported(draft_cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device 'cuda' requested but no CUDA device is available "
                    "(pass device='cpu' to run on the CPU)")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        if max_batch < 1 or max_seq < 2:
            raise ValueError(f"need max_batch >= 1 and max_seq >= 2, got "
                             f"{max_batch}x{max_seq}")
        # Speculative decoding needs BOTH halves: a draft model and a
        # proposal depth.
        if (draft_params is None) != (spec_tokens < 1):
            raise ValueError(
                "speculative decoding needs draft_params AND "
                f"spec_tokens >= 1 together (got draft_params="
                f"{'set' if draft_params is not None else 'None'}, "
                f"spec_tokens={spec_tokens})")
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab ({draft_cfg.vocab}) must equal the "
                    f"target vocab ({cfg.vocab}): the acceptance ratio "
                    f"test compares distributions over one vocabulary")
        # Tensor-parallel serving (serve/shard.py): shard > 1 runs the
        # target programs on that many members. The geometry is checked
        # now: indivisible head counts and missing devices are config
        # typos, not runtime surprises.
        self.shard = max(int(shard), 1)
        self.member_hbm_budget = max(int(member_hbm_budget), 0)
        if self.shard > 1:
            gen.shard_config(cfg, self.shard)  # head-divisibility check
            devices = shardlib.member_devices(self.shard, devices)
        # Prefill/decode disaggregation: the role rides stats() so the
        # router can split a request across tiers; on the data path it only
        # decides whether the retire hook exports (set_handoff_export).
        self.role = str(role)
        if self.role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"role must be prefill, decode or mixed, got {role!r}")
        # The fault points' ``engine`` context.
        self.name = str(name)
        # Chunked prefill: long prompt tails prefill in slices of this many
        # tokens, one decode step over the residents between slices.
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.queue_depth = queue_depth
        self.default_max_new = default_max_new
        self.prefix_block = max(1, int(prefix_block))
        prefix_on = prefix_cache_bytes > 0 and int(prefix_block) >= 1
        # Pages default to the prefix-block size so a prefix block IS a
        # page; the pool defaults to the dense max_batch x max_seq tokens.
        self.page_tokens = int(kv_page_tokens) or self.prefix_block
        if self.page_tokens < 1:
            raise ValueError(
                f"kv_page_tokens must be >= 1, got {self.page_tokens}")
        if prefix_on and self.page_tokens != self.prefix_block:
            raise ValueError(
                f"zero-copy prefix sharing needs kv_page_tokens "
                f"({self.page_tokens}) == prefix_block "
                f"({self.prefix_block}); set them equal or disable the "
                f"prefix cache (prefix_cache_bytes=0)")
        self.n_blocks = -(-max_seq // self.page_tokens)
        pool_tokens = int(kv_pool_tokens) or max_batch * max_seq
        if pool_tokens < self.page_tokens:
            raise ValueError(
                f"kv_pool_tokens ({pool_tokens}) is smaller than one "
                f"{self.page_tokens}-token page")
        n_pages = pool_tokens // self.page_tokens
        page_bytes = (2 * cfg.n_layers * self.page_tokens * cfg.n_kv_heads
                      * cfg.head_dim * cfg.dtype.itemsize)
        self._pagepool = PagePool(n_pages, self.page_tokens, page_bytes)
        # Per-member memory budget: a member holds 1/shard of the split
        # weight leaves, the replicated leaves whole, and 1/shard of every
        # page. A model that does not fit is refused here, at boot.
        if self.member_hbm_budget:
            shardlib.check_member_budget(params, self.shard, n_pages * page_bytes,
                                         self.member_hbm_budget)
        self.kv_host_bytes = max(0, int(kv_host_bytes))
        self._host_tier = (HostTier(self.kv_host_bytes)
                           if prefix_on and self.kv_host_bytes else None)
        self._prefix = (
            PrefixStore(prefix_cache_bytes, self.prefix_block, self._pagepool,
                        demote=(self._demote_page
                                if self._host_tier is not None else None))
            if prefix_on else None)
        if self._host_tier is not None:
            self._pagepool.register_tier("host", self._host_tier.stats)
        # Fleet prefix sharing (serve/kvvolume.py): called with (chain, m)
        # when the store and the host tier matched only m blocks; None,
        # empty or any failure recomputes locally.
        self._kv_fetch = kv_fetch if prefix_on else None
        # Chains this engine exported (deepest hash -> volume id), advertised
        # in the serve row.
        self._exported: dict[str, str] = {}
        # The prefill tier's retire hook (set_handoff_export).
        self._handoff_export = None
        M.SERVE_ROLE.labels(role=self.role).set(1)
        # Full cumulative-hash chains of recent admissions (deepest hash ->
        # ordered chain, MRU last): the order an exporter needs to rebuild
        # a chain, which only the admitting request knew.
        self._hot_chains: collections.OrderedDict[str, tuple] = collections.OrderedDict()
        # +1 physical page: id 0 is the reserved scratch page every
        # unmapped table entry points at.
        self._group = None
        if self.shard > 1:
            # Each member holds only its weight slice and its KV-head slice
            # of every page, on its own device.
            self._group = shardlib.member_group(devices)
            lcfg = gen.shard_config(cfg, self.shard)
            self.params = [shardlib.member_params(params, self.shard, k, d)
                           for k, d in enumerate(devices)]
            self._cache = [gen.init_page_pool(lcfg, n_pages + 1, self.page_tokens, device=d)
                           for d in devices]
        else:
            self.params = _to_device(params, self.device)
            self._cache = gen.init_page_pool(cfg, n_pages + 1, self.page_tokens,
                                             device=self.device)
        self._decode_fwd, self._prefill_fwd, self._verify_fwd = target_forwards(
            cfg, self.page_tokens, self._group)
        self._member_watch = None
        self._members_ok = True

        self.spec_tokens = int(spec_tokens) if draft_params is not None else 0
        if self.spec_tokens:
            dcfg = draft_cfg
            self._draft_cfg = dcfg
            self._draft_params = _to_device(draft_params, self.device)
            draft_pool_tokens = int(spec_pool_tokens) or pool_tokens
            if draft_pool_tokens < self.page_tokens:
                raise ValueError(
                    f"spec_pool_tokens ({draft_pool_tokens}) is smaller "
                    f"than one {self.page_tokens}-token page")
            draft_page_bytes = (2 * dcfg.n_layers * self.page_tokens
                                * dcfg.n_kv_heads * dcfg.head_dim
                                * dcfg.dtype.itemsize)
            n_draft_pages = draft_pool_tokens // self.page_tokens
            self._draft_pagepool = PagePool(
                n_draft_pages, self.page_tokens, draft_page_bytes,
                track_metrics=False)
            self._draft_cache = gen.init_page_pool(
                dcfg, n_draft_pages + 1, self.page_tokens, device=self.device)
            self._valve = AcceptanceValve(
                floor=spec_accept_floor, window_rounds=spec_window_rounds,
                reprobe_rounds=spec_reprobe_rounds)

        # Per-slot host state (the scheduler's view; device state is the
        # page pool plus what the last step returned).
        self._slots: list[_Request | None] = [None] * max_batch
        self._tokens = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        self._temps = np.zeros(max_batch, np.float32)
        # The sampled requests' generators, per slot (None: greedy or idle;
        # such rows draw nothing).
        self._gens: list[torch.Generator | None] = [None] * max_batch
        self._draft_gens: list[torch.Generator | None] = [None] * max_batch
        # Page tables: host-authored only, uploaded lazily; every admission
        # and retirement invalidates the device copy, so a freed page can
        # never be re-allocated while a stale device table still routes an
        # idle row's writes at it. Unmapped entries are 0 = scratch.
        self._tables = np.zeros((max_batch, self.n_blocks), np.int64)
        self._tables_dev = None
        self._slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
        # Draft-side slot state: a row with draft pages is a SPEC row; a
        # row whose draft allocation failed (or admitted while the valve
        # was closed) decodes at plain semantics through the same verify
        # (spec_mask False).
        self._spec_row = [False] * max_batch
        self._draft_tables = np.zeros((max_batch, self.n_blocks), np.int64)
        self._draft_tables_dev = None
        self._spec_mask_dev = None
        self._draft_slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_fallbacks = 0
        self._target_steps = 0
        self._decode_tokens = 0
        self._row_steps = 0  # live rows summed over target steps
        self._kv_tokens = 0  # live rows' keys (prompt + emitted) over target steps
        self._decode_host_s = 0.0  # host turns outside admission passes
        self._prefill_stall_s = 0.0  # admissions that held resident rows
        # The open host turn (_open_host_turn): its start and its range.
        self._host_from: float | None = None
        self._host_range: Any = None
        self._in_admit = False
        self._admit_mark = 0.0  # where the pass's current admission began
        self._admit_decode_s = 0.0  # decode rounds run inside that admission
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefill_cached = 0
        self._prefill_computed = 0
        self._pool_blocked_episodes = 0
        self._pool_blocked = False
        # Device-resident step operands (tokens, pos, temps): the decode
        # loop feeds each step the previous step's outputs. None = the
        # host mirrors are fresher (an admission wrote a row).
        self._dev: tuple | None = None
        self._zero_draws: dict[int, torch.Tensor] = {}
        self._pending: collections.deque[_Request] = collections.deque()
        # Engine-thread command queue: another thread's read of the device
        # pool (a chain snapshot for an export) runs between steps
        # (_call_on_engine).
        self._cmds: collections.deque = collections.deque()
        self._admitting: _Request | None = None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stopping = False
        self._draining = False
        # Completion times inside the QPS window.
        self._completions: collections.deque[float] = collections.deque()
        self.finished_total = 0
        # The engine thread's traceback if it died ("error" requests).
        self.error: str | None = None
        self._thread = threading.Thread(
            target=self._run, name="oim-serve-engine", daemon=True)
        self._thread.start()

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new: int = 0, temperature: float = 0.0,
               seed: int = 0, eos: int = -1) -> GenHandle:
        """Queue one request; returns immediately with its handle. Raises
        ``QueueFull`` (bounded queue) or ``Draining`` (engine stopping),
        and ``ValueError`` for an inadmissible request."""
        prompt = [int(t) for t in prompt]
        max_new = int(max_new) or self.default_max_new
        temperature = float(temperature)
        if not prompt:
            raise ValueError("empty prompt")
        if temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the engine's max_seq {self.max_seq}")
        # Fault point: an armed QueueFull/Draining instance simulates an
        # admission refusal. A simulated QueueFull counts as rejected, as
        # the real one below does; the real Draining records nothing.
        try:
            faultinject.fire("serve.admit", engine=self.name)
        except QueueFull:
            M.SERVE_REQUESTS_TOTAL.labels(outcome="rejected").inc()
            raise
        need = self._blocks_needed(len(prompt), max_new)
        if need > self._pagepool.n_pages:
            # A request the whole pool can never hold would queue forever.
            raise ValueError(
                f"request needs {need} KV pages "
                f"({self.page_tokens} tokens each) but the pool holds "
                f"{self._pagepool.n_pages}; raise kv_pool_tokens or "
                f"lower max_new_tokens")
        req = _Request(prompt=prompt, max_new=max_new, temperature=temperature,
                       seed=int(seed), eos=int(eos),
                       submitted_at=time.monotonic(),
                       trace_ctx=tracing.current_context())
        with self._lock:
            if self._stopping or self._draining:
                raise Draining("engine is draining; not accepting requests")
            if len(self._pending) >= self.queue_depth:
                M.SERVE_REQUESTS_TOTAL.labels(outcome="rejected").inc()
                raise QueueFull(
                    f"admission queue full ({self.queue_depth} waiting)")
            self._pending.append(req)
            M.SERVE_QUEUE_DEPTH.set(len(self._pending))
            self._work.notify()
        return GenHandle(req)

    # -- lifecycle ----------------------------------------------------------

    def stop(self, drain: bool = True, timeout: float = 60.0,
             quiet: bool = False) -> None:
        """Shut the engine down. ``drain=True`` finishes every RESIDENT
        request first; queued requests finish as "drained" either way.
        ``quiet`` suppresses the replica_drain event (a harness simulating
        a killed process, which would have emitted nothing)."""
        with self._lock:
            active = sum(s is not None for s in self._slots)
            queued = len(self._pending)
        # Emitted BEFORE the drain flag flips: the event is the cause of
        # the Draining refusals that follow, and the ring keeps that order.
        if not quiet:
            events.emit(events.REPLICA_DRAIN, graceful=drain,
                        active_slots=active, queued=queued)
        with self._lock:
            self._draining = True
            if not drain:
                self._stopping = True
            self._work.notify()
        self._thread.join(timeout=timeout)

    @property
    def active_slots(self) -> int:
        with self._lock:
            return sum(s is not None for s in self._slots)

    @property
    def queue_len(self) -> int:
        with self._lock:
            return len(self._pending)

    def set_member_watch(self, fn) -> None:
        """Register the member-liveness poll (a callable returning
        ``{"ready": n, "stale": n, "total": shard}``, as ``ShardMembers.
        member_counts`` does in the JAX package) that a sharded replica's
        stats() folds into its readiness. It may do a registry RPC, so
        stats() calls it outside the engine lock."""
        self._member_watch = fn

    def stats(self) -> dict:
        """One consistent load snapshot, the reference's keys: what the
        serve row publishes and the router routes on."""
        counts = None
        if self.shard > 1 and self._member_watch is not None:
            counts = self._member_watch()  # may be an RPC: never under lock
        with self._lock:
            active = sum(s is not None for s in self._slots)
            snap = {
                "free_slots": self.max_batch - active,
                "active_slots": active,
                "queue_depth": len(self._pending),
                "queue_capacity": self.queue_depth,
                "max_batch": self.max_batch,
                "ready": not (self._draining or self._stopping),
                "target_steps": self._target_steps,
                "decode_tokens": self._decode_tokens,
                "role": self.role,
            }
            if self.role == "prefill":
                # A COLD prefill replica advertises its block too: the
                # router's split gate compares the prompt against it, and
                # the row carries the block only beside hot prefixes.
                snap["prefix_block"] = self.prefix_block
            if self.shard > 1:
                # One lapsed member flips the whole replica not-ready: a
                # group missing a member cannot decode.
                ready_members = (min(int(counts["ready"]), self.shard)
                                 if counts else self.shard)
                members_ok = ready_members >= self.shard
                snap["shard_total"] = self.shard
                snap["shard_ready"] = ready_members
                snap["ready"] = snap["ready"] and members_ok
                if counts is not None:
                    M.SERVE_SHARD_MEMBERS.labels(state="ready").set(counts["ready"])
                    M.SERVE_SHARD_MEMBERS.labels(state="stale").set(counts.get("stale", 0))
                if members_ok != self._members_ok:
                    events.emit(
                        events.SHARD_MEMBER_LOST if not members_ok
                        else events.SHARD_MEMBER_HEALED,
                        engine=self.name, ready=ready_members, total=self.shard)
                    self._members_ok = members_ok
            if self.spec_tokens:
                proposed, accepted = self._spec_proposed, self._spec_accepted
                snap.update({
                    "spec_tokens": self.spec_tokens,
                    "spec_on": self._valve.open,
                    "spec_rounds": self._spec_rounds,
                    "spec_proposed": proposed,
                    "spec_accepted": accepted,
                    "spec_accept_rate": (
                        round(accepted / proposed, 4) if proposed else None),
                    "spec_accept_rate_rolling": (
                        round(r, 4) if (r := self._valve.rate()) is not None
                        else None),
                    "spec_fallbacks": self._spec_fallbacks,
                })
            return snap

    def hot_prefixes(self, n: int | None = None) -> list[str]:
        """The hottest cached chain hashes (MRU first), ``n`` of them
        (default ``ADVERTISE_PREFIXES``): what the serve row advertises for
        the router's prefix-affinity pick. Empty when the cache is
        disabled."""
        if self._prefix is None:
            return []
        return self._prefix.hot(self.ADVERTISE_PREFIXES if n is None else n)

    def prefix_tiers(self, n: int | None = None) -> dict:
        """Hash -> tier ("hbm" | "host") for the serve row: the hottest
        store entries, then the hottest demoted blocks (a hash in both
        tiers reads "hbm"). Empty when the prefix cache is disabled."""
        limit = self.ADVERTISE_PREFIXES if n is None else n
        out = {h: "hbm" for h in self.hot_prefixes(limit)}
        if self._host_tier is not None:
            for h in self._host_tier.hot(limit):
                out.setdefault(h, "host")
        return out

    def host_stats(self) -> dict:
        """Host-tier census; zeros when tiering is off."""
        if self._host_tier is None:
            return {"entries": 0, "bytes": 0, "capacity_bytes": 0,
                    "demotions": 0, "promotions": 0}
        return self._host_tier.stats()

    def evict_prefix_store(self) -> int:
        """Drop every prefix-store reference NOW (store-only pages demote
        into the host tier first when tiering is on). The demotion reads
        the device pool, so call it only on an idle or stopped engine.
        Returns pages freed."""
        if self._prefix is None:
            return 0
        return self._prefix.evict_all()

    def evict_host_tier(self) -> int:
        """Drop every demoted block NOW. Returns blocks dropped."""
        if self._host_tier is None:
            return 0
        return self._host_tier.evict_all()

    def set_kv_fetch(self, fn) -> None:
        """(Re)wire the peer-fetch callback on a running engine (None
        disables it). No-op while the prefix cache is disabled."""
        if self._prefix is not None:
            self._kv_fetch = fn

    def request_stats(self) -> dict:
        """Request census: the running counts the reference keeps in its
        metrics only, so they stay off the serve row."""
        with self._lock:
            return {
                "finished_total": self.finished_total,
                "decode_row_steps": self._row_steps,
                "decode_kv_tokens": self._kv_tokens,
                "decode_host_seconds": self._decode_host_s,
                "prefill_stall_seconds": self._prefill_stall_s,
                "prefix_hits": self._prefix_hits,
                "prefix_misses": self._prefix_misses,
                "prefill_tokens_cached": self._prefill_cached,
                "prefill_tokens_computed": self._prefill_computed,
                "pool_blocked_episodes": self._pool_blocked_episodes,
            }

    def prefix_stats(self) -> dict:
        """Prefix-store census; zeros when disabled."""
        if self._prefix is None:
            return {"entries": 0, "bytes": 0, "capacity_bytes": 0,
                    "block": self.prefix_block}
        return self._prefix.stats()

    def pool_stats(self) -> dict:
        """Page-pool census: totals, occupancy, sharing, the peak, and
        ``dense_equiv_pages`` (what a max_batch x max_seq dense cache would
        reserve in page units)."""
        s = self._pagepool.stats()
        s["dense_equiv_pages"] = self.max_batch * self.n_blocks
        return s

    def spec_stats(self) -> dict:
        """Speculation census: the draft pool's occupancy plus the valve
        state; zeros when speculation is not configured."""
        if not self.spec_tokens:
            return {"enabled": False, "spec_tokens": 0,
                    "draft_total_pages": 0, "draft_used_pages": 0,
                    "draft_free_pages": 0, "draft_peak_used_pages": 0,
                    "spec_on": False}
        s = self._draft_pagepool.stats()
        return {
            "enabled": True,
            "spec_tokens": self.spec_tokens,
            "draft_total_pages": s["total_pages"],
            "draft_used_pages": s["used_pages"],
            "draft_free_pages": s["free_pages"],
            "draft_peak_used_pages": s["peak_used_pages"],
            "spec_on": self._valve.open,
        }

    def _blocks_needed(self, n_prompt: int, max_new: int) -> int:
        """Pages an admission reserves: the positions the request can
        write, prompt [0, n) plus decode [n, n + max_new - 1) (the final
        token is emitted, never written back)."""
        tokens = max(1, n_prompt + max_new - 1)
        return -(-tokens // self.page_tokens)

    # -- engine loop --------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                while True:
                    with self._lock:
                        while (not self._pending and not self._cmds
                               and not any(s is not None for s in self._slots)
                               and not (self._stopping or self._draining)):
                            self._end_host_turn()
                            self._work.wait()
                        if self._stopping or self._draining:
                            self._fail_pending_locked("drained")
                        stop_now = self._stopping
                        done = (self._stopping or self._draining) and not any(
                            s is not None for s in self._slots)
                    if done:
                        self._fail_cmds()
                        return
                    if stop_now:
                        self._evict_all("drained")
                        self._fail_cmds()
                        return
                    self._service_cmds()
                    self._admit()
                    if any(s is not None for s in self._slots):
                        self._decode_once()
        except Exception as err:  # noqa: BLE001 - the loop IS the engine
            self.error = traceback.format_exc()
            from_context().error("serve engine died; failing all requests",
                                 error=repr(err), traceback=self.error)
            self._evict_all("error")
            if self._admitting is not None:
                self._finish(self._admitting, "error")
            with self._lock:
                self._stopping = True
                self._fail_pending_locked("error")
            self._fail_cmds()
        finally:
            self._end_host_turn()

    def _fail_pending_locked(self, reason: str) -> None:
        while self._pending:
            self._finish(self._pending.popleft(), reason)
        M.SERVE_QUEUE_DEPTH.set(0)

    # -- engine-thread command queue ----------------------------------------

    def _service_cmds(self) -> None:
        while True:
            with self._lock:
                if not self._cmds:
                    return
                fn, box = self._cmds.popleft()
            try:
                box["result"] = fn()
            except Exception as err:  # noqa: BLE001 - relayed to the caller
                box["error"] = err
            box["done"].set()

    def _fail_cmds(self) -> None:
        while True:
            with self._lock:
                if not self._cmds:
                    return
                _, box = self._cmds.popleft()
            box["error"] = Draining("engine stopped before the command ran")
            box["done"].set()

    def _call_on_engine(self, fn, timeout: float = 30.0):
        """Run ``fn`` on the engine thread between steps and return its
        result: the only way for another thread to read the device pool,
        which the engine's steps write in place."""
        if threading.current_thread() is self._thread:
            return fn()
        box: dict = {"done": threading.Event(), "result": None, "error": None}
        with self._lock:
            if self._stopping or self._draining:
                raise Draining("engine is draining; not taking commands")
            self._cmds.append((fn, box))
            self._work.notify()
        if not box["done"].wait(timeout):
            raise TimeoutError(f"engine command did not run within {timeout}s")
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    # -- KV tiering / fleet prefix sharing ------------------------------------

    def snapshot_chain(self, hashes, timeout: float = 30.0):
        """Host copies of a cached chain's blocks, in chain order, of the
        pool's dtype (bf16 as ``uint16`` bits): the export's read
        (``serve/kvvolume.py`` packs them). Runs on the engine thread through
        the command queue; the pages are ref'd for the copy, so no eviction
        can free them mid-read. None when the chain is not fully cached
        anymore."""
        hashes = list(hashes)
        if self._prefix is None or not hashes:
            return None
        dtype = host_dtype(self.cfg.dtype)

        def snap():
            pages = self._prefix.gather(hashes)
            if pages is None:
                return None
            self._pagepool.ref(pages)
            try:
                return [tuple(a.view(dtype) for a in self._page_kv(p)) for p in pages]
            finally:
                self._pagepool.unref(pages)

        return self._call_on_engine(snap, timeout=timeout)

    def note_exported(self, deepest_hash: str, volume_id: str) -> None:
        """Record a chain this replica exported (the serve row advertises
        the map so peers can resolve holder volumes)."""
        with self._lock:
            self._exported[str(deepest_hash)] = str(volume_id)

    def exported_volumes(self) -> dict:
        with self._lock:
            return dict(self._exported)

    def set_handoff_export(self, fn) -> None:
        """Arm the prefill tier's retire hook: ``fn(engine, hashes)`` runs on
        the engine thread when a slot retires by eos or length with an
        exportable chain, before its stream closes (oim-serve wires
        ``kvvolume.export_chain`` here for --role prefill). None disarms."""
        with self._lock:
            self._handoff_export = fn

    def hot_chains(self, n: int = 4) -> list[tuple]:
        """The full cumulative-hash chains of the most recent admissions,
        MRU first: what the background exporter walks. A chain may have
        partly evicted since; the export re-checks through
        ``snapshot_chain``."""
        with self._lock:
            chains = list(self._hot_chains.values())
        chains.reverse()
        return chains[:max(0, int(n))]

    def _page_kv(self, page: int):
        """One physical page's (k, v) on the host, every member's KV heads
        assembled on a sharded replica."""
        if self._group is None:
            return page_kv(self._cache, page)
        return shardlib.pool_page_kv(self._cache, page, page_kv)

    def _demote_page(self, key: str, page: int) -> None:
        """PrefixStore demote hook: copy the evicting store-only page into
        the host tier."""
        self._host_tier.put(key, *self._page_kv(page))

    def _alloc_one(self) -> int | None:
        """One fresh page for a promotion or an adoption, shedding cold
        store references first under pressure."""
        pages = self._pagepool.alloc(1)
        if pages is None and self._prefix is not None:
            self._prefix.release(1)
            pages = self._pagepool.alloc(1)
        return pages[0] if pages else None

    def _install_block(self, key: str, page: int, shared: list[int]) -> None:
        """Index one freshly staged page: the store takes its own ref, the
        page's alloc-time ref becomes this admission's pin."""
        self._prefix.install(key, page)
        shared.append(page)

    def _promote_tail(self, chain: list[str], m: int, shared: list[int]) -> int:
        """Extend the device match with host-tier blocks: copy each
        consecutive demoted block into a fresh page (the host entry pops
        once the bytes are back). Stops at the first gap or on pool
        pressure; returns the new matched depth."""
        if self._host_tier is None:
            return m
        while m < len(chain):
            got = self._host_tier.get(chain[m])
            if got is None:
                break
            page = self._alloc_one()
            if page is None:
                break
            if self._group is None:
                stage_page(self._cache, page, got[0], got[1])
            else:
                shardlib.stage_pool_page(self._cache, page, got[0], got[1], stage_page)
            self._host_tier.pop(chain[m])
            self._install_block(chain[m], page, shared)
            m += 1
        return m

    def _adopt_peer(self, chain: list[str], m: int, shared: list[int],
                    req: _Request) -> int:
        """Fleet tier: ask the kv_fetch callback for the unmatched chain tail
        and write the consecutive blocks it returns into fresh pages in one
        batch. ANY failure (the callback raising or returning None, a
        block out of order, pool pressure mid-adoption, a block the pool
        cannot take) leaves a valid shorter prefix, and the prefill computes
        the rest: never a misaligned resume."""
        try:
            fetched = self._kv_fetch(chain, m)
        except Exception as err:  # noqa: BLE001 - fallback is recompute
            events.emit(events.KV_FETCH_FALLBACK, trace_id=self._trace_id(req),
                        error=repr(err), matched_blocks=m, chain_blocks=len(chain))
            return m
        if fetched is None:
            events.emit(events.KV_FETCH_FALLBACK, trace_id=self._trace_id(req),
                        matched_blocks=m, chain_blocks=len(chain))
            return m
        keys, pages, ks, vs = [], [], [], []
        for key, (k, v) in fetched:
            if m + len(keys) >= len(chain) or key != chain[m + len(keys)]:
                break  # only a consecutive continuation may adopt
            page = self._alloc_one()
            if page is None:
                break
            keys.append(key)
            pages.append(page)
            ks.append(k)
            vs.append(v)
        if not keys:
            return m
        try:
            if self._group is None:
                stage_pages(self._cache, pages, ks, vs)
            else:
                shardlib.stage_pool_pages(self._cache, pages, ks, vs, stage_pages)
        except Exception as err:  # noqa: BLE001 - e.g. a peer's shape skew
            self._pagepool.unref(pages)
            events.emit(events.KV_FETCH_FALLBACK, trace_id=self._trace_id(req),
                        error=repr(err), matched_blocks=m, chain_blocks=len(chain))
            return m
        for key, page in zip(keys, pages):
            self._install_block(key, page, shared)
        m += len(keys)
        M.SERVE_PREFIX_PEER_TOKENS.inc(len(keys) * self.prefix_block)
        events.emit(events.KV_PEER_FETCH, trace_id=self._trace_id(req),
                    blocks=len(keys), tokens=len(keys) * self.prefix_block)
        return m

    def _evict_all(self, reason: str) -> None:
        for i, req in enumerate(self._slots):
            if req is not None:
                # Hard eviction: no prefix donation, but every page returns.
                self._release_slot(i, req, retain=False)
                with self._lock:
                    self._slots[i] = None
                events.emit(events.SLOT_EVICTED,
                            trace_id=self._trace_id(req), slot=i,
                            reason=reason, tokens=req.emitted)
                self._finish(req, reason)
        self._occupancy()

    def _occupancy(self) -> None:
        M.SERVE_SLOT_OCCUPANCY.set(
            sum(s is not None for s in self._slots) / self.max_batch)

    def _finish(self, req: _Request, reason: str) -> None:
        req.finish_reason = reason
        req.finished_at = time.monotonic()
        self._record_phases(req)
        req.out.put(_DONE)
        self.finished_total += 1
        M.SERVE_REQUESTS_TOTAL.labels(outcome=reason).inc()
        now = req.finished_at
        self._completions.append(now)
        while (self._completions
               and now - self._completions[0] > self.QPS_WINDOW_S):
            self._completions.popleft()
        span = max(now - self._completions[0], 1e-3)
        M.SERVE_QPS.set(
            len(self._completions) / max(span, self.QPS_WINDOW_S / 2))

    @staticmethod
    def _trace_id(req: _Request) -> str:
        return req.trace_ctx.trace_id if req.trace_ctx is not None else ""

    def _record_phases(self, req: _Request) -> None:
        """The request's phase spans, recorded at retirement: their
        boundaries (submit, admit, first token, finish) are monotonic
        marks, complete only now, and the spans take wall-clock starts
        derived from them."""
        now_wall, now_mono = time.time(), time.monotonic()

        def wall(mono: float) -> float:
            return now_wall - (now_mono - mono)

        if req.admitted_at and req.admitted_at > req.submitted_at:
            tracing.record_phase(
                "serve.queue_wait", wall(req.submitted_at),
                req.admitted_at - req.submitted_at, parent=req.trace_ctx)
        first = req.token_times[0] if req.token_times else 0.0
        if first and req.finished_at > first and req.emitted > 1:
            tracing.record_phase(
                "serve.decode", wall(first), req.finished_at - first,
                parent=req.trace_ctx, tokens=req.emitted - 1)

    def _emit(self, req: _Request, token: int) -> None:
        now = time.monotonic()
        base = req.token_times[-1] if req.token_times else req.submitted_at
        # kind splits the SLO (submit -> first token) from the decode
        # cadence; the request's trace_id rides the bucket as an exemplar.
        kind = "first" if req.emitted == 0 else "next"
        M.SERVE_TOKEN_LATENCY.labels(kind=kind).observe(
            now - base, self._trace_id(req))
        if kind == "first":
            M.SERVE_FIRST_TOKEN.labels(
                prefix="hit" if req.prefix_tokens else "miss").observe(
                now - base, self._trace_id(req))
        M.SERVE_TOKENS_TOTAL.inc()
        req.token_times.append(now)
        if req.emitted:
            self._decode_tokens += 1
        req.emitted += 1
        req.out.put(int(token))

    def _bucket(self, n: int) -> int:
        b = self.MIN_PREFILL_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of it: the host
        mirrors keep changing)."""
        return torch.tensor(arr, device=self.device)

    def _draws(self, gens, n: int) -> torch.Tensor:
        """[B, n] U[0,1) draws: n from each sampled row's generator, zeros
        for the rows without one (greedy or idle)."""
        if n not in self._zero_draws:
            self._zero_draws[n] = torch.zeros(n, device=self.device)
        zero = self._zero_draws[n]
        if not any(g is not None for g in gens):
            return zero.expand(len(gens), n)
        return torch.stack([zero if g is None else
                            torch.rand(n, generator=g, device=self.device)
                            for g in gens])

    def _sync_host(self) -> None:
        """Pull the device-resident step operands back into the host
        mirrors before an admission writes a row; the next step uploads
        the merged state once."""
        if self._dev is None:
            return
        d_tokens, d_pos, _ = self._dev
        self._tokens = d_tokens.cpu().numpy().copy()
        self._pos = d_pos.cpu().numpy().copy()
        self._dev = None

    def _open_host_turn(self) -> None:
        """A step's tokens came back, or an admission pass ended: the
        engine thread's host turn (emission, retirement, the loop's way
        back) runs until the next step or pass begins or the engine idles,
        a ``serve.emit`` range whose time ``decode_host_seconds`` counts.
        A decode round run inside an admission pass opens none."""
        if self._in_admit:
            return
        self._host_from = time.monotonic()
        self._host_range = tracing.device_range("serve.emit")
        self._host_range.__enter__()

    def _end_host_turn(self) -> None:
        if self._host_from is not None:
            self._decode_host_s += time.monotonic() - self._host_from
            self._host_from = None
            self._host_range.__exit__(None, None, None)

    def _admit(self) -> None:
        """One admission pass, when a slot is free and a request queued: a
        ``serve.admit`` range around it. Each admission in it whose prefill
        started while a row was resident adds its host time (from the end
        of the one before, less decode rounds run between prefill chunks)
        to ``prefill_stall_seconds`` as it ends."""
        with self._lock:
            if not self._pending or all(s is not None for s in self._slots):
                return
        self._end_host_turn()
        self._in_admit, self._admit_mark, self._admit_decode_s = True, time.monotonic(), 0.0
        try:
            with tracing.device_range("serve.admit"):
                self._admit_requests()
        finally:
            self._in_admit = False
            self._open_host_turn()

    def _admit_requests(self) -> None:
        """Insert queued requests into free slots (prefill between decode
        steps). Admission reserves the request's pages first; an exhausted
        pool leaves the request AT THE HEAD of the queue and returns. The
        head is PEEKED, not popped, until its pages are mapped."""
        while True:
            with self._lock:
                free = next(
                    (i for i, s in enumerate(self._slots) if s is None), None)
                if free is None or not self._pending:
                    return
                req = self._pending[0]
                cancelled = req.cancelled.is_set()
                if cancelled:
                    self._pending.popleft()
                    M.SERVE_QUEUE_DEPTH.set(len(self._pending))
            if cancelled:
                self._finish(req, "cancelled")
                continue
            n = len(req.prompt)
            m, shared = 0, []
            if self._prefix is not None:
                chain = prefixhash.usable_hashes(req.prompt, self.prefix_block)
                if chain:
                    with self._lock:
                        self._hot_chains[chain[-1]] = tuple(chain)
                        self._hot_chains.move_to_end(chain[-1])
                        while len(self._hot_chains) > self.ADVERTISE_PREFIXES * 4:
                            self._hot_chains.popitem(last=False)
                m = self._prefix.match(chain)
                if m:
                    got = self._prefix.gather(chain[:m])
                    if got is None:
                        m = 0  # a link evicted between match and gather
                    else:
                        shared = got
                        # Pin the shared pages NOW, before any eviction.
                        self._pagepool.ref(shared)
                # The tail's tiers: host-RAM blocks first, then the fleet
                # tier's peer-exported blocks; both leave pinned pages, as a
                # store hit does.
                if m < len(chain):
                    m = self._promote_tail(chain, m, shared)
                if self._kv_fetch is not None and m < len(chain):
                    m = self._adopt_peer(chain, m, shared, req)
            if not self._map_slot(req, free, n, m, shared):
                return  # still the queue head; retried next loop pass
            spec_row = self._map_draft_slot(req, free, n)
            with self._lock:
                self._pending.popleft()
                M.SERVE_QUEUE_DEPTH.set(len(self._pending))
            self._admitting = req  # failed with the engine if it dies here
            req.admitted_at = time.monotonic()
            # Admission backpressure: how long the queue (and the page
            # pool) held this request before its prefill started.
            M.SERVE_QUEUE_WAIT.observe(
                req.admitted_at - req.submitted_at, self._trace_id(req))
            gen_ = (_generator(req.seed, self.device)
                    if req.temperature > 0 else None)
            resident = any(s is not None for s in self._slots)
            tok = self._prefill_slot(req, free, n, m, gen_)
            if spec_row:
                self._draft_prefill_slot(req, free, n)
            self._sync_host()  # merge device state before writing the row
            self._tokens[free] = tok
            self._pos[free] = n
            self._temps[free] = req.temperature
            self._gens[free] = gen_
            self._spec_row[free] = spec_row
            with self._lock:
                self._slots[free] = req
            self._admitting = None
            self._occupancy()
            self._emit(req, tok)
            self._retire_if_done(free, req, tok)
            now = time.monotonic()
            if resident:
                self._prefill_stall_s += now - self._admit_mark - self._admit_decode_s
            self._admit_mark, self._admit_decode_s = now, 0.0

    def _map_slot(self, req: _Request, slot: int, n: int,
                  m: int, shared: list[int]) -> bool:
        """Build slot ``slot``'s page table: ``m`` shared prefix pages
        (pinned by the caller) then fresh private pages for the tail and
        decode blocks. On pool pressure the prefix store releases
        unreferenced pages first; if the pool still cannot cover the
        request, every pin is undone and False backpressures."""
        need = self._blocks_needed(n, req.max_new)
        private = self._pagepool.alloc(need - m)
        if private is None and self._prefix is not None:
            deficit = (need - m) - self._pagepool.free_pages
            self._prefix.release(deficit)
            private = self._pagepool.alloc(need - m)
        if private is None:
            if shared:
                self._pagepool.unref(shared)
            if not self._pool_blocked:
                self._pool_blocked = True
                self._pool_blocked_episodes += 1
                events.emit(events.PAGE_POOL_EXHAUSTED,
                            trace_id=self._trace_id(req),
                            needed_pages=need - m,
                            free_pages=self._pagepool.free_pages,
                            total_pages=self._pagepool.n_pages,
                            queued=self.queue_len)
            return False
        self._pool_blocked = False
        pages = shared + private
        self._slot_pages[slot] = pages
        self._tables[slot, :] = 0
        self._tables[slot, :len(pages)] = pages
        self._tables_dev = None
        return True

    def _map_draft_slot(self, req: _Request, slot: int, n: int) -> bool:
        """Reserve the request's draft pages (the target's footprint
        math). False (plain decode for this request) when speculation is
        off, the valve is closed, or the draft pool can't cover it."""
        if not self.spec_tokens or not self._valve.open:
            return False
        try:
            # Fault point: an armed InjectedFault IS a draft-pool
            # allocation failure (the request decodes plainly).
            faultinject.fire("spec.propose", engine=self.name)
        except faultinject.InjectedFault:
            return False
        pages = self._draft_pagepool.alloc(self._blocks_needed(n, req.max_new))
        if pages is None:
            return False
        self._draft_slot_pages[slot] = pages
        self._draft_tables[slot, :] = 0
        self._draft_tables[slot, :len(pages)] = pages
        self._draft_tables_dev = None
        self._spec_mask_dev = None
        return True

    def _draft_prefill_slot(self, req: _Request, slot: int, n: int) -> None:
        """Fill the draft's cache with the whole prompt (the draft keeps no
        prefix store; its logits are discarded, since a round's first input
        is always the TARGET's last emission) and start the row's draft
        generator."""
        padded = np.zeros((1, self._bucket(n)), np.int64)
        padded[0, :n] = req.prompt
        with tracing.start_span(
                "serve.draft_prefill", parent=req.trace_ctx, slot=slot,
                prompt_tokens=n):
            gen.prefill_into_pages(
                self._draft_params, self._upload(padded), n, self._draft_cache,
                self._upload(self._draft_tables[slot]), 0, self._draft_cfg,
                self.page_tokens)
        if req.temperature > 0:
            self._draft_gens[slot] = _generator(req.seed ^ DRAFT_KEY_FOLD,
                                                self.device)

    def _release_draft(self, slot: int) -> None:
        """Return a slot's draft pages and zero its draft table."""
        pages = self._draft_slot_pages[slot]
        if pages:
            self._draft_pagepool.unref(pages)
        self._draft_slot_pages[slot] = []
        self._draft_tables[slot, :] = 0
        self._draft_tables_dev = None
        self._spec_row[slot] = False
        self._spec_mask_dev = None
        self._draft_gens[slot] = None

    def _first_token(self, req, tail, table, start, gen_) -> int:
        padded = np.zeros((1, self._bucket(len(tail))), np.int64)
        padded[0, :len(tail)] = tail
        temp = torch.full((1,), req.temperature, device=self.device)
        tok = prefill_program(
            self._prefill_fwd, self.params, self._cache, self._upload(padded), len(tail),
            table, start, temp, self._draws([gen_], 1)[:, 0])
        return int(tok[0])

    def _prefill_slot(self, req: _Request, slot: int, n: int, m: int, gen_) -> int:
        """One request's prefill through slot ``slot``'s page table: the
        first ``m`` blocks are shared store pages read in place, the tail
        lands in the slot's private pages. Returns the first token."""
        P = m * self.prefix_block
        tail = req.prompt[P:]
        if self.prefill_chunk and len(tail) > self.prefill_chunk:
            tok = self._prefill_chunked(req, slot, n, m, gen_)
        else:
            span_attrs = {"slot": slot, "prompt_tokens": n}
            if P:
                span_attrs["prefix_tokens"] = P
            with tracing.start_span(
                    "serve.prefill", parent=req.trace_ctx, **span_attrs):
                tok = self._first_token(
                    req, tail, self._upload(self._tables[slot]), P, gen_)
        if self._prefix is not None:
            if P:
                req.prefix_tokens = P
                self._prefix_hits += 1
                self._prefill_cached += P
                M.SERVE_PREFIX_HITS.inc()
                M.SERVE_PREFILL_TOKENS.labels(source="cache").inc(P)
            else:
                self._prefix_misses += 1
                M.SERVE_PREFIX_MISSES.inc()
        self._prefill_computed += n - P
        M.SERVE_PREFILL_TOKENS.labels(source="compute").inc(n - P)
        return tok

    def _prefill_chunked(self, req: _Request, slot: int, n: int, m: int,
                         gen_) -> int:
        """The prompt tail in ``prefill_chunk``-token slices, one decode
        round over the RESIDENT slots between slices. Every slice runs the
        same prefill at a shifted ``start``; only the last samples. Each
        slice is timed to its device completion (the reference's slices
        each end in a token fetch) into oim_serve_prefill_chunk_seconds.

        While slices interleave with decode, this slot's table row is
        ZEROED (the prefill runs through a device copy of the row): the
        row is not in _slots yet, so lockstep decode treats it as idle,
        and an idle row's write must land on scratch page 0, never in the
        freshly mapped pages (some of them SHARED store pages)."""
        P = m * self.prefix_block
        tail = req.prompt[P:]
        chunk = self.prefill_chunk
        table_row = self._tables[slot].copy()
        self._tables[slot, :] = 0
        self._tables_dev = None
        draft_row = None
        if self.spec_tokens:
            draft_row = self._draft_tables[slot].copy()
            self._draft_tables[slot, :] = 0
            self._draft_tables_dev = None
        table_dev = self._upload(table_row)
        with tracing.start_span(
                "serve.prefill", parent=req.trace_ctx, slot=slot,
                prompt_tokens=n, chunk_tokens=chunk,
                chunks=-(-len(tail) // chunk)):
            for off in range(0, len(tail), chunk):
                piece = tail[off:off + chunk]
                t0 = time.monotonic()
                if off + chunk < len(tail):
                    padded = np.zeros((1, self._bucket(len(piece))), np.int64)
                    padded[0, :len(piece)] = piece
                    self._prefill_fwd(self.params, self._upload(padded), len(piece),
                                      self._cache, table_dev, P + off)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    M.SERVE_PREFILL_CHUNK_SECONDS.observe(
                        time.monotonic() - t0, self._trace_id(req))
                    with self._lock:
                        resident = any(r is not None for r in self._slots)
                    if resident:
                        t_round = time.monotonic()
                        self._decode_once()
                        self._admit_decode_s += time.monotonic() - t_round
                else:
                    tok = self._first_token(req, piece, table_dev, P + off, gen_)
                    M.SERVE_PREFILL_CHUNK_SECONDS.observe(
                        time.monotonic() - t0, self._trace_id(req))
        self._tables[slot, :] = table_row
        self._tables_dev = None
        if draft_row is not None:
            self._draft_tables[slot, :] = draft_row
            self._draft_tables_dev = None
        return tok

    def _release_slot(self, slot: int, req: _Request,
                      retain: bool = True) -> None:
        """Return a retiring slot's pages. With ``retain``, first donate
        the prompt's FULL blocks to the prefix store BY REFERENCE, then
        drop the slot's own references. The table row zeroes so the idle
        row writes scratch page 0. Retained bytes are a pure function of
        the prompt's tokens: decode only writes positions >= len(prompt),
        which live in later pages."""
        pages = self._slot_pages[slot]
        if retain and self._prefix is not None and pages:
            hashes = prefixhash.chain_hashes(req.prompt, self.prefix_block)
            if hashes:
                self._prefix.retain(hashes, pages[:len(hashes)])
        if pages:
            self._pagepool.unref(pages)
        self._slot_pages[slot] = []
        self._tables[slot, :] = 0
        self._tables_dev = None
        self._gens[slot] = None
        if self.spec_tokens:
            self._release_draft(slot)

    def _retire_if_done(self, slot: int, req: _Request, token: int) -> bool:
        if req.cancelled.is_set():
            reason = "cancelled"
        elif req.eos >= 0 and token == req.eos:
            reason = "eos"
        elif req.emitted >= req.max_new:
            reason = "length"
        else:
            return False
        # Fault point: a crash AT retirement, before any page returns.
        faultinject.fire("serve.retire", engine=self.name, reason=reason)
        self._release_slot(slot, req)
        with self._lock:
            self._slots[slot] = None
            export = self._handoff_export
        if export is not None and reason != "cancelled":
            # The prefill tier's handoff: the chain this retirement just
            # donated to the store exports NOW, on the engine thread, before
            # _finish closes the stream, so the decode pick's fetch finds it.
            self._export_handoff(req, export)
        if reason == "cancelled":
            # eos/length retirement is the steady state; an eviction by
            # cancel is an incident for the flight recorder.
            events.emit(events.SLOT_EVICTED, trace_id=self._trace_id(req),
                        slot=slot, reason=reason, tokens=req.emitted)
        self._occupancy()
        self._finish(req, reason)
        return True

    def _export_handoff(self, req: _Request, export) -> None:
        """Export the retiring request's prompt chain: ``usable_hashes``, the
        full-block prefix a decode admission MATCHES, so the volume id is the
        deepest hash the decode pick's fetcher probes. Deduped on that hash:
        re-publishing an exported volume id is a feeder error."""
        hashes = prefixhash.usable_hashes(req.prompt, self.prefix_block)
        if not hashes:
            M.SERVE_PREFILL_HANDOFFS.labels(outcome="skipped").inc()
            return
        with self._lock:
            done = hashes[-1] in self._exported
        if done:
            M.SERVE_PREFILL_HANDOFFS.labels(outcome="skipped").inc()
            return
        try:
            volume_id = export(self, list(hashes))
        except Exception:  # noqa: BLE001 - the handoff is best-effort
            from_context().warning(
                "prefill handoff export failed; decode falls back to local prefill",
                trace_id=self._trace_id(req))
            M.SERVE_PREFILL_HANDOFFS.labels(outcome="export_failed").inc()
            return
        M.SERVE_PREFILL_HANDOFFS.labels(
            outcome="exported" if volume_id else "export_failed").inc()

    def _cancel_slot(self, slot: int, req: _Request) -> None:
        self._release_slot(slot, req)
        with self._lock:
            self._slots[slot] = None
        events.emit(events.SLOT_EVICTED, trace_id=self._trace_id(req),
                    slot=slot, reason="cancelled", tokens=req.emitted)
        self._occupancy()
        self._finish(req, "cancelled")

    def _decode_once(self) -> None:
        """One decode round over every resident slot: a speculative round
        when a draft is configured, the valve is open and a live slot holds
        a draft cache; one plain lockstep step otherwise (a closed valve's
        plain rounds tick the re-probe cooldown)."""
        # Fault point: an armed fault wedges the engine; the loop's
        # catch-all fails every request and stops admissions.
        faultinject.fire("serve.decode", engine=self.name)
        if self.spec_tokens:
            if self._valve.open:
                with self._lock:
                    any_spec = any(r is not None and self._spec_row[i]
                                   for i, r in enumerate(self._slots))
                if any_spec:
                    self._spec_once()
                    return
            elif self._valve.tick_plain():
                from_context().info("speculation re-probing after cooldown",
                                    reprobe_rounds=self._valve.reprobe_rounds)
        self._plain_once()

    def _operands(self):
        if self._dev is None:
            self._dev = (self._upload(self._tokens), self._upload(self._pos),
                         self._upload(self._temps))
        if self._tables_dev is None:
            self._tables_dev = self._upload(self._tables)
        return self._dev

    def _observe_ici(self, live) -> None:
        """One allreduce observation per target dispatch (sharded replicas
        only): the per-layer sums inside a step cannot be host-timed one by
        one, so one 1 KiB allreduce over the same members is timed instead;
        the exemplar carries a live request's trace_id."""
        M.SERVE_ICI_ALLREDUCE.observe(shardlib.time_allreduce(self._group),
                                      self._trace_id(live[0][1]) if live else "")

    def _spec_once(self) -> None:
        """One speculative round: the draft proposes K tokens per row, the
        target verifies all K in ONE forward, and each live row emits its
        accepted prefix plus one target-supplied token. Rows without a
        draft slot ride the same programs at plain-decode semantics."""
        K = self.spec_tokens
        self._end_host_turn()
        with tracing.device_range("serve.decode_step"):
            d_tokens, d_pos, d_temps = self._operands()
            if self._draft_tables_dev is None:
                self._draft_tables_dev = self._upload(self._draft_tables)
            with self._lock:
                live = [(i, r) for i, r in enumerate(self._slots) if r is not None]
                spec_rows = list(self._spec_row)
            if self._spec_mask_dev is None:
                self._spec_mask_dev = torch.tensor(spec_rows, device=self.device)
            draft_toks, draft_logits = propose_program(
                self._draft_params, self._draft_cache, d_tokens, d_pos, d_temps,
                self._draws(self._draft_gens, K + 1), self._draft_tables_dev,
                self._draft_cfg, self.page_tokens, self.max_seq, K)
            out, n_emit, tok, pos = verify_program(
                self._verify_fwd, self.params, self._cache, d_tokens, d_pos, d_temps,
                self._draws(self._gens, K + 1), self._tables_dev, draft_toks,
                draft_logits, self._spec_mask_dev, self.max_seq)
            self._dev = (tok, pos, d_temps)
            fetched = torch.cat([out, n_emit[:, None]], dim=1).cpu().numpy()
            out, n_emit = fetched[:, :-1], fetched[:, -1]  # the per-round sync
        self._open_host_turn()
        self._target_steps += 1
        if self._group is not None:
            self._observe_ici(live)
        self._row_steps += len(live)
        self._kv_tokens += sum(len(r.prompt) + r.emitted for _, r in live)
        self._spec_rounds += 1
        proposed = K * sum(spec_rows)
        accepted = sum(int(n_emit[i]) - 1 for i, _ in live if spec_rows[i])
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        if proposed:
            M.SERVE_SPEC_PROPOSED.inc(proposed)
            if accepted:
                M.SERVE_SPEC_ACCEPTED.inc(accepted)
        closed_now = self._valve.observe(proposed, accepted)
        rolling = self._valve.rate()
        if rolling is not None:
            # The valve's own window (the fallback signal), not the
            # lifetime ratio.
            M.SERVE_SPEC_ACCEPT_ROLLING.set(round(rolling, 4))
        if closed_now:
            # The draft stopped predicting this traffic: fall back to plain
            # decode, release the live rows' draft pages now, re-probe
            # after the cooldown.
            self._spec_fallbacks += 1
            M.SERVE_SPEC_FALLBACK.inc()
            events.emit(events.SPEC_FALLBACK,
                        accept_floor=self._valve.floor,
                        window_rounds=self._valve.window_rounds,
                        reprobe_rounds=self._valve.reprobe_rounds,
                        proposed_total=self._spec_proposed,
                        accepted_total=self._spec_accepted)
            from_context().info("speculation fell back to plain decode",
                                accept_floor=self._valve.floor)
            for i, _ in live:
                if spec_rows[i]:
                    self._release_draft(i)
        for i, req in live:
            if req.cancelled.is_set():
                self._cancel_slot(i, req)
                continue
            # The device advanced past every token of the round; the host
            # emits what the request's budget admits and stops at the
            # first EOS.
            count = min(int(n_emit[i]), req.max_new - req.emitted)
            for t in out[i, :count]:
                self._emit(req, int(t))
                if self._retire_if_done(i, req, int(t)):
                    break

    def _plain_once(self) -> None:
        """One lockstep decode step over every resident slot; idle rows
        compute a discarded token. Each step's outputs ARE the next step's
        operands, so steady-state decode costs one step plus one [B] token
        fetch."""
        self._end_host_turn()
        with tracing.device_range("serve.decode_step"):
            d_tokens, d_pos, d_temps = self._operands()
            tok, pos = decode_program(
                self._decode_fwd, self.params, self._cache, d_tokens, d_pos, d_temps,
                self._draws(self._gens, 1)[:, 0], self._tables_dev, self.max_seq)
            self._dev = (tok, pos, d_temps)
            tok = tok.cpu().numpy()  # the only per-step sync
        self._open_host_turn()
        self._target_steps += 1
        with self._lock:
            live = [(i, r) for i, r in enumerate(self._slots) if r is not None]
        if self._group is not None:
            self._observe_ici(live)
        self._row_steps += len(live)
        self._kv_tokens += sum(len(r.prompt) + r.emitted for _, r in live)
        for i, req in live:
            if req.cancelled.is_set():
                self._cancel_slot(i, req)
                continue
            self._emit(req, int(tok[i]))
            self._retire_if_done(i, req, int(tok[i]))
