"""The streaming request router: ``oim.v1.Serve`` fanned out over N
replicas.

Pick policy — least-loaded with a power-of-two-choices tie-break: a
replica's score is its advertised backlog (``queue_depth - free_slots``,
from the heartbeat snapshot, which is up to one beat stale) plus the
router's OWN in-flight count against it (live, and exactly the part the
stale snapshot misses). The lowest score routes; among tied scores two
candidates are sampled and the one with fewer router-local in-flight
streams wins — the classic balls-into-bins result, which keeps a fleet
of routers from herding onto one replica between heartbeats.

Prefix affinity — a TIE-BREAK on top of that, never a hotspot
generator: each replica's heartbeat row advertises its hot prefix-cache
chain hashes (serve/registration.py); the router hashes the request's
prompt the same way (common/prefixhash.py — both sides MUST agree) and
prefers the replica holding the LONGEST advertised prefix of it, but
only while that holder's score is within ``affinity_guard`` of the
least-loaded pick. Beyond the guard — or when the holder is drained
(ready:false), lease-lapsed, or marked failed — the pick falls back to
plain least-loaded: a popular system prompt must not stack every
request on one replica, and the pre-first-token retry contract is
unchanged (a retry excludes the tried holder and re-picks). Replicas
that advertise nothing (prefix cache off, pre-upgrade build) stay fully
routable; they just never attract affinity.

Retry contract — before the first token delta ONLY: a replica answering
``RESOURCE_EXHAUSTED`` (admission queue full) or ``UNAVAILABLE``
(dead/draining) is retried once on the NEXT replica by score, and
``UNAVAILABLE`` additionally evicts the replica from the table until a
registry poll proves it back. During a rolling weight upgrade the
re-pick prefers replicas advertising the FIRST attempt's ``version``
when any remain (a response must not splice two models), and streams
past the first token never migrate at all — which is the whole
version-pinning contract: an in-flight stream stays on the replica
(hence the version) it started on. After the first token has streamed, any
upstream failure surfaces to the client unchanged: a sampled stream must
never be silently replayed — the retry would re-sample and splice two
different completions into one response.

Cancel/deadline — the client's deadline rides the upstream call
(``context.time_remaining()``), and a client cancel fires
``call.cancel()`` on the upstream stream, which evicts the replica's
decode slot at its next step boundary (serve/service.py); an abandoned
router stream never pins replica capacity.

Data plane — bytes pass-through: the router registers ``Generate`` with
IDENTITY serializers (the registry proxy's trick, registry.py) and
forwards raw frames, so a token delta is never deserialized or
re-serialized on the hop. The router parses exactly two messages per
stream — the request (for the span's prompt size) and the final delta
(for the outcome label) — not the token stream; per-token router cost is
one Python yield of a bytes object, which is what lets a 2-core bench
box route 2 replicas' worth of streams without the hop eating a
replica's share of the machine.
"""

from __future__ import annotations

import collections
import itertools
import random
import threading
import time

import grpc

from oim_tpu_torch.common import (
    channelpool,
    events,
    faultinject,
    metrics as M,
    prefixhash,
    tracing,
)
from oim_tpu_torch.common.identity import IdentityService
from oim_tpu_torch.common.interceptors import LogServerInterceptor
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.server import NonBlockingGRPCServer
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.router.table import Replica, ReplicaTable
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import add_identity_to_server

GENERATE_METHOD = "/oim.v1.Serve/Generate"

_IDENTITY = lambda b: b  # noqa: E731 - bytes pass-through serdes


class RouterService:
    """oim.v1.Serve over a ReplicaTable: pick, pass through, retry.

    ``Generate`` speaks RAW BYTES on both sides (see the module
    docstring's data-plane note); it is registered through a generic
    handler with identity serdes, not the typed servicer."""

    # One pick plus one retry on the next replica — the whole retry
    # budget (see the module docstring's retry contract).
    MAX_ATTEMPTS = 2
    RETRY_CODES = (
        grpc.StatusCode.RESOURCE_EXHAUSTED,
        grpc.StatusCode.UNAVAILABLE,
    )

    # A prefix holder wins the pick only while its score (advertised
    # backlog + router-local in-flight) is within this many requests of
    # the least-loaded candidate's — the line between "reuse the cache"
    # and "pile onto the replica everyone's system prompt lives on".
    AFFINITY_GUARD = 2

    def __init__(
        self,
        table: ReplicaTable,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        upstream_lanes: int = 4,
        affinity: bool = True,
        affinity_guard: int | None = None,
        disagg: bool = True,
    ):
        self.table = table
        self.tls = tls
        self.affinity = affinity
        # Prefill/decode disaggregation: when the table holds a
        # prefill-tier replica (and at least one non-prefill row), the
        # router SPLITS a long-prompt request — the prompt runs on the
        # prefill pick (whose retirement exports the finished chain as
        # a content-addressed volume), the stream runs on the normal
        # pick (whose kv-fetch adopts the pages instead of
        # recomputing). Off, or with no prefill tier registered, every
        # request routes exactly as before.
        self.disagg = bool(disagg)
        self.affinity_guard = (self.AFFINITY_GUARD if affinity_guard is None
                               else affinity_guard)
        self._pool = pool if pool is not None else channelpool.shared()
        # A replica hosts max_batch concurrent streams from this router;
        # laid on ONE HTTP/2 connection they serialize on its single
        # flow-control window and in-order frame stream (measured: enough
        # to halve 2-replica scaling), so upstream streams stripe
        # round-robin over ``upstream_lanes`` pooled connections per
        # replica (common/channelpool.py lanes).
        self.upstream_lanes = max(1, upstream_lanes)
        self._next_lane = itertools.count()
        # Router-local in-flight streams per replica id: the live overlay
        # on the (one-beat-stale) heartbeat load snapshots.
        self._inflight: collections.Counter[str] = collections.Counter()
        self._lock = threading.Lock()

    # -- pick -------------------------------------------------------------

    def _score(self, replica: Replica, inflight: int) -> int:
        return replica.queue_depth - replica.free_slots + inflight

    def pick(self, exclude: frozenset | set = frozenset(),
             prompt=None, prefix_len: int = 0) -> Replica | None:
        """The least-loaded routable replica (power-of-two-choices among
        ties), or None when nothing is routable. With a ``prompt`` (and
        affinity enabled), a replica advertising the longest cached
        prefix of it wins instead — if its score is within the load
        guard of the least-loaded pick."""
        replica, _ = self._pick(exclude, prompt, prefix_len)
        return replica

    @staticmethod
    def _request_hashes(candidates, prompt, prefix_len: int,
                        cache: dict) -> dict:
        """Fill ``cache`` with the request's chain hashes, one list per
        advertised block size (usable_hashes mirrors the engine's
        admission lookup: full blocks, >= 1 token left to prefill;
        ``prefix_len`` caps the hashed prefix to the part the client
        declared shared). Computed BEFORE the pick lock — sha256 over a
        long prompt is CPU work no other request's pick should
        serialize behind — and the caller keeps the cache for the whole
        request, so a pre-first-token retry's re-pick never re-hashes."""
        for r in candidates:
            if r.prefix_block < 1 or r.prefix_block in cache \
                    or not (r.prefix_hashes or r.prefix_hosted):
                continue
            hashes = prefixhash.usable_hashes(prompt, r.prefix_block)
            if prefix_len > 0:
                hashes = hashes[:prefix_len // r.prefix_block]
            cache[r.prefix_block] = hashes
        return cache

    @staticmethod
    def _match_blocks(replica: Replica,
                      hash_cache: dict) -> tuple[int, int]:
        """(blocks, hbm_blocks): how many leading blocks of the
        request's prompt this replica holds in ANY resident tier
        (HBM store or demoted host RAM — both serve without a
        prefill), and how many it holds in HBM specifically. The
        cost model reads the pair: at equal depth an HBM holder
        beats a host holder (a host hit pays one H2D re-stage per
        block). Volume-only advertisements do NOT count — an exported
        chain is fetchable by ANY replica over the data path, so
        herding toward its publisher buys nothing. (0, 0) = no
        affinity."""
        hashes = hash_cache.get(replica.prefix_block, ())
        resident = replica.prefix_hashes | replica.prefix_hosted
        for i in range(len(hashes) - 1, -1, -1):
            if hashes[i] in resident:
                hbm = 0
                for j in range(i, -1, -1):
                    if hashes[j] in replica.prefix_hashes:
                        hbm = j + 1
                        break
                return i + 1, hbm
        return 0, 0

    def _pick(self, exclude: frozenset | set = frozenset(),
              prompt=None, prefix_len: int = 0,
              hash_cache: dict | None = None,
              prefer_version: str = ""
              ) -> tuple[Replica | None, bool]:
        """(replica, was_affinity_pick) — times the one pick
        implementation: the scan is linear in table rows, so
        oim_router_pick_seconds is the per-request control-plane tax
        bench.py --control-plane curves at 10/100/1000 rows."""
        t0 = time.monotonic()
        try:
            return self._pick_inner(exclude, prompt, prefix_len,
                                    hash_cache, prefer_version)
        finally:
            M.ROUTER_PICK_SECONDS.observe(time.monotonic() - t0,
                                          exemplar=tracing.trace_id())

    def _pick_inner(self, exclude: frozenset | set = frozenset(),
                    prompt=None, prefix_len: int = 0,
                    hash_cache: dict | None = None,
                    prefer_version: str = ""
                    ) -> tuple[Replica | None, bool]:
        """The one pick implementation. ``hash_cache`` is the
        per-request hash memo (block size ->
        chain hashes) — _route passes one dict across retry attempts.
        ``prefer_version`` is the rolling-upgrade pin: a retry re-pick
        prefers replicas advertising the FIRST attempt's weights version
        (the two halves of one response must come from one model), but
        falls back to any routable replica when none remain — a
        preference, never a filter, so the last v1 replica draining
        mid-upgrade cannot strand a retry (mixed-version safe)."""
        faultinject.fire("router.pick", tried=len(exclude))
        candidates = [r for r in self.table.replicas()
                      if r.replica_id not in exclude]
        if not candidates:
            return None, False
        # Prefill-tier rows take only the prompt half of a split
        # request (_prefill_split dials them directly); the stream
        # pick skips them — unless they are ALL that's routable, where
        # serving whole requests from the prefill tier beats refusing
        # (a prefill replica is a complete engine, just mis-packed).
        non_prefill = [r for r in candidates if r.role != "prefill"]
        if non_prefill:
            candidates = non_prefill
        if prefer_version:
            same = [r for r in candidates if r.version == prefer_version]
            if same:
                candidates = same
        affine = self.affinity and bool(prompt)
        hash_cache = hash_cache if hash_cache is not None else {}
        if affine:
            self._request_hashes(candidates, prompt, prefix_len,
                                 hash_cache)
        with self._lock:
            scored = [(self._score(r, self._inflight[r.replica_id]), r)
                      for r in candidates]
            best = min(score for score, _ in scored)
            if affine and hash_cache:
                # Longest advertised prefix wins; at equal depth the
                # tier breaks the tie (HBM holder over host holder —
                # the host hit pays an H2D re-stage per block); then
                # ties go to the lower score, so two equal holders of
                # one hot prefix still balance between themselves.
                neg_blocks, _, score, i = min(
                    (-blocks, -hbm, score, i)
                    for i, (score, r) in enumerate(scored)
                    for blocks, hbm in (self._match_blocks(r, hash_cache),)
                )
                if neg_blocks < 0 and score <= best + self.affinity_guard:
                    M.ROUTER_AFFINITY_PICKS.inc()
                    return scored[i][1], True
            ties = [r for score, r in scored if score == best]
            if len(ties) == 1:
                return ties[0], False
            two = random.sample(ties, 2)  # noqa: S311 - load balancing
            counts = [self._inflight[r.replica_id] for r in two]
        if counts[0] != counts[1]:
            return (two[0] if counts[0] < counts[1] else two[1]), False
        return random.choice(two), False  # noqa: S311 - load balancing

    # -- the streaming pass-through ---------------------------------------

    def Generate(self, request, context):
        # ``request`` is RAW BYTES (identity deserializer); parse it once
        # for the span — the token stream itself is never parsed. The
        # span parent comes from the RAW metadata, and the hop span is
        # injected explicitly into the upstream call: a generator body
        # cannot rely on the server interceptor's ambient contextvar
        # (same stance as the registry's transparent proxy).
        parent = tracing.extract(context.invocation_metadata())
        prompt, prefix_len = None, 0
        try:
            parsed = pb.GenerateRequest.FromString(request)
            prompt = list(parsed.prompt)
            prefix_len = parsed.prefix_len
            prompt_tokens = len(prompt)
        except Exception:  # noqa: BLE001 - malformed request: let the
            prompt_tokens = -1  # replica answer with the real parse error
        with tracing.start_span(
                "router.generate", parent=parent,
                prompt_tokens=prompt_tokens) as span:
            yield from self._route(request, context, span,
                                   prompt, prefix_len)

    def _one_attempt(self, replica, request, context, span):
        """Open the upstream stream and yield ('delta', bytes) items;
        terminal items are ('done', finish_reason) / ('err', RpcError)."""
        try:
            # Armed with an InjectedRpcError, the fault takes the SAME
            # path a refusing/dead upstream does: the retry contract and
            # pool eviction run without a process to kill.
            faultinject.fire("router.stream", replica=replica.replica_id)
        except grpc.RpcError as err:
            yield ("err", err)
            return
        metadata = tracing.inject([], span.context)
        channel = self._pool.get(
            replica.endpoint, self.tls,
            lane=next(self._next_lane) % self.upstream_lanes)
        call = channel.unary_stream(
            GENERATE_METHOD, request_serializer=_IDENTITY,
            response_deserializer=_IDENTITY,
        )(request, timeout=context.time_remaining(), metadata=metadata)
        # Client cancel / deadline expiry -> cancel the upstream stream,
        # which evicts the replica's decode slot at the next step
        # boundary. add_callback returns False when the RPC already
        # terminated — then cancel here or the upstream slot leaks its
        # full decode budget.
        if not context.add_callback(call.cancel):
            call.cancel()
        last = b""
        try:
            for delta in call:
                last = delta
                yield ("delta", delta)
            # One parse per stream, of the FINAL frame only: the outcome
            # label for the metrics below.
            reason = ""
            if last:
                try:
                    final = pb.GenerateDelta.FromString(last)
                    reason = final.finish_reason if final.done else ""
                except Exception:  # noqa: BLE001 - label-only parse
                    reason = ""
            yield ("done", reason)
        except grpc.RpcError as err:
            yield ("err", err)

    def _prefill_split(self, context, span, prompt) -> None:
        """The prompt half of a disaggregated request: run the prompt
        through the least-loaded prefill-tier replica as a synthetic
        1-token greedy generate, drained and DISCARDED — its only
        product is the side effect, the retired chain exported as a
        content-addressed volume the stream pick's kv-fetch adopts.
        Every defect degrades to plain routing (the stream pick
        prefills locally — slower, never wrong), so this method never
        raises and never touches the client stream."""
        replicas = self.table.replicas()
        prefill = [r for r in replicas if r.role == "prefill"]
        if not prefill or len(prefill) == len(replicas):
            return  # no prefill tier, or nothing left to stream from
        with self._lock:
            target = min(
                prefill,
                key=lambda r: self._score(r, self._inflight[r.replica_id]))
        if target.prefix_block < 1 \
                or len(prompt) <= target.prefix_block:
            # Nothing exportable: the chain a decode admission can
            # adopt is the prompt's FULL blocks with >= 1 token left
            # to prefill, so a sub-block prompt ships zero pages.
            return
        handoff = pb.GenerateRequest(
            prompt=prompt, max_new_tokens=1, temperature=0.0,
            seed=0).SerializeToString()
        try:
            channel = self._pool.get(
                target.endpoint, self.tls,
                lane=next(self._next_lane) % self.upstream_lanes)
            call = channel.unary_stream(
                GENERATE_METHOD, request_serializer=_IDENTITY,
                response_deserializer=_IDENTITY,
            )(handoff, timeout=context.time_remaining(),
              metadata=tracing.inject([], span.context))
            if not context.add_callback(call.cancel):
                call.cancel()
            for _ in call:
                pass
            span.attrs["prefill_split"] = target.replica_id
            M.SERVE_PREFILL_HANDOFFS.labels(outcome="split").inc()
        except Exception:  # noqa: BLE001 - best-effort by contract
            self.table.mark_failed(target.replica_id)
            M.SERVE_PREFILL_HANDOFFS.labels(outcome="fallback").inc()
            from_context().warning(
                "prefill handoff failed; falling back to local prefill",
                replica=target.replica_id)

    def _route(self, request, context, span, prompt=None,
               prefix_len: int = 0):
        log = from_context()
        if self.disagg and prompt:
            self._prefill_split(context, span, prompt)
        tried: set[str] = set()
        last_err: grpc.RpcError | None = None
        hash_cache: dict = {}  # one hashing of the prompt per request
        pinned_version = ""  # the first pick's advertised weights version
        for attempt in range(self.MAX_ATTEMPTS):
            replica, affine = self._pick(tried, prompt, prefix_len,
                                         hash_cache, pinned_version)
            if replica is None:
                break
            if attempt == 0:
                pinned_version = replica.version
            tried.add(replica.replica_id)
            rid = replica.replica_id
            span.attrs["replica"] = rid
            if affine:
                span.attrs["affinity"] = True
            elif "affinity" in span.attrs:
                # A retry after an affinity pick re-picked plain
                # least-loaded: the span must not credit the final
                # replica with an affinity herd it didn't get.
                span.attrs["affinity"] = False
            with self._lock:
                self._inflight[rid] += 1
            streamed = 0  # frames forwarded (a frame = >=1 token delta)
            try:
                for kind, item in self._one_attempt(
                        replica, request, context, span):
                    if kind == "delta":
                        streamed += 1
                        yield item
                        continue
                    if kind == "done":
                        span.attrs["outcome"] = item or "done"
                        span.attrs["deltas"] = streamed
                        M.ROUTER_REQUESTS_TOTAL.labels(
                            replica=rid, outcome=item or "done").inc()
                        return
                    err = item  # kind == "err"
                    self._pool.maybe_evict(err, replica.endpoint)
                    if not context.is_active():
                        # The CLIENT went away (cancel/deadline); the
                        # upstream CANCELLED is our own doing. Nothing
                        # to answer — the RPC is already dead.
                        span.attrs["outcome"] = "cancelled"
                        M.ROUTER_REQUESTS_TOTAL.labels(
                            replica=rid, outcome="cancelled").inc()
                        return
                    if streamed == 0 and err.code() in self.RETRY_CODES \
                            and attempt + 1 < self.MAX_ATTEMPTS:
                        # Pre-first-token failure: this replica is full
                        # or gone — try the next one, once.
                        if err.code() is grpc.StatusCode.UNAVAILABLE:
                            self.table.mark_failed(rid)
                        M.ROUTER_RETRIES_TOTAL.inc()
                        M.ROUTER_REQUESTS_TOTAL.labels(
                            replica=rid, outcome="retried").inc()
                        # Flight recorder: THE event behind "why was this
                        # request's first token slow" — stamped with the
                        # request's trace_id (the hop span's), so
                        # /debug/events?trace=<id> surfaces it.
                        events.emit(events.ROUTER_RETRY,
                                    trace_id=span.trace_id, replica=rid,
                                    code=err.code().name,
                                    attempt=attempt + 1)
                        log.warning(
                            "retrying on next replica", replica=rid,
                            code=err.code().name)
                        last_err = err
                        break
                    # Mid-stream failure (or retry budget spent): surface
                    # it — a sampled stream is never silently replayed.
                    span.attrs["outcome"] = "error"
                    span.attrs["code"] = err.code().name
                    M.ROUTER_REQUESTS_TOTAL.labels(
                        replica=rid, outcome="error").inc()
                    context.abort(err.code(), err.details() or
                                  err.code().name)
            finally:
                with self._lock:
                    self._inflight[rid] -= 1
                    if self._inflight[rid] <= 0:
                        del self._inflight[rid]
        span.attrs["outcome"] = "unroutable"
        M.ROUTER_REQUESTS_TOTAL.labels(
            replica="", outcome="unroutable").inc()
        if last_err is not None:
            context.abort(
                last_err.code(),
                f"all replicas failed; last: {last_err.details()}")
        context.abort(
            grpc.StatusCode.UNAVAILABLE,
            "no ready serve replicas in the routing table")


class _GenerateHandler(grpc.GenericRpcHandler):
    """Registers the router's Generate with IDENTITY serdes, so frames
    pass through as raw bytes (the typed ``add_serve_to_server`` path
    would deserialize + re-serialize every token delta on the hop)."""

    def __init__(self, service: RouterService):
        self._service = service

    def service(self, handler_call_details):
        if handler_call_details.method != GENERATE_METHOD:
            return None
        return grpc.unary_stream_rpc_method_handler(
            self._service.Generate,
            request_deserializer=_IDENTITY,
            response_serializer=_IDENTITY,
        )


def router_server(
    endpoint: str, service: RouterService, tls: TLSConfig | None = None,
    max_workers: int = 128,
) -> NonBlockingGRPCServer:
    """Serve the router's Serve + Identity services on one endpoint (the
    same co-serving shape as every other oim daemon). The Identity ready
    probe answers false while the routing table is empty, so
    orchestration never points clients at a router with nowhere to
    send them.

    ``max_workers`` bounds concurrent ROUTED STREAMS (each holds its
    executor thread for the stream's lifetime), so it defaults well
    above the worker-pool default — a router's whole job is fan-in, and
    backpressure belongs to the replicas' bounded admission queues."""
    identity = IdentityService(
        "oim-router",
        capabilities=["service:serve", "role:router"],
        ready_fn=lambda: len(service.table) > 0,
    )
    server = NonBlockingGRPCServer(
        endpoint, tls=tls, interceptors=(LogServerInterceptor(),),
        max_workers=max_workers,
    )

    def register(s):
        s.add_generic_rpc_handlers((_GenerateHandler(service),))
        add_identity_to_server(identity, s)

    server.start(register)
    return server
