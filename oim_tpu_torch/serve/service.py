"""The ``oim.v1.Serve`` daemon service (``oim_tpu/serve/service.py``):
streaming Generate over the port's continuous-batching engine, with JAX's
status codes, deltas and capabilities.

The gRPC layer stays as thin as the feeder daemon's: it translates the
engine's exceptions into wire statuses (QueueFull -> RESOURCE_EXHAUSTED,
the backpressure contract; Draining -> UNAVAILABLE so load balancers
rotate away during shutdown; bad requests -> INVALID_ARGUMENT) and
translates stream lifecycle into slot lifecycle — a client cancel or an
expired deadline fires ``context.add_callback``, which evicts the
request's slot at the next step boundary, so an abandoned stream never
holds decode-batch capacity.

Token deltas coalesce: each message carries every token the engine has
produced since the previous one, so a slow consumer reads fewer, fatter
messages instead of stalling behind one-token writes (the engine
never blocks on the stream either way — its per-request queue absorbs
the gap). ``stream_tokens`` sets the granularity floor: the FIRST token
always flushes immediately (first-token latency is the latency SLO),
later deltas wait for up to ``stream_tokens`` tokens before flushing —
every message costs a full Python-gRPC send/recv on each hop (replica,
router, client), so chunked streaming is the difference between the
serving path scaling with replicas and eating a replica's share of CPU.
"""

from __future__ import annotations

import queue

import grpc

from oim_tpu_torch.common import tracing
from oim_tpu_torch.common.identity import IdentityService
from oim_tpu_torch.common.interceptors import LogServerInterceptor
from oim_tpu_torch.common.server import NonBlockingGRPCServer
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.serve.engine import _DONE, Draining, QueueFull, ServeEngine
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import (
    ServeServicer,
    add_identity_to_server,
    add_serve_to_server,
)

# How long one delta waits for its first token before checking whether
# the call died: bounds how long an evicted/broken stream's generator
# thread lingers, without adding latency to live streams (tokens arrive
# way inside this at any realistic decode rate).
_POLL_S = 0.5


class ServeService(ServeServicer):
    """oim.v1.Serve over a ServeEngine."""

    def __init__(self, engine: ServeEngine, stream_tokens: int = 1):
        self.engine = engine
        # Tokens per delta after the first (1 = flush every token, the
        # lowest-latency and chattiest setting; see module docstring).
        self.stream_tokens = max(1, stream_tokens)

    def Generate(self, request, context):
        with tracing.start_span(
                "serve.generate", prompt_tokens=len(request.prompt),
                max_new=request.max_new_tokens) as span:
            try:
                handle = self.engine.submit(
                    request.prompt,
                    max_new=request.max_new_tokens,
                    temperature=request.temperature,
                    seed=request.seed,
                    # proto3 cannot distinguish an unset 0 from token id 0,
                    # so 0 joins the negative values as "disabled".
                    eos=request.eos_token if request.eos_token > 0 else -1,
                )
            except QueueFull as err:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(err))
            except Draining as err:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(err))
            except ValueError as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
            # Client cancel / deadline expiry -> evict the slot at the
            # next step boundary (idempotent on normal completion).
            # add_callback returns False when the RPC already terminated
            # (cancel raced the submit) — then nothing would ever fire
            # it, so cancel here or the orphan holds a slot for its full
            # decode budget.
            if not context.add_callback(handle.cancel):
                handle.cancel()
            yield from self._deltas(handle, context, span)

    def _deltas(self, handle, context, span):
        out = handle._req.out
        done = False
        first_sent = False
        while not done:
            try:
                item = out.get(timeout=_POLL_S)
            except queue.Empty:
                if not context.is_active():
                    # The call died and the engine has nothing for us —
                    # cancel (the add_callback already did) and let the
                    # eviction's _DONE drain through on a later pass.
                    handle.cancel()
                continue
            tokens = []
            if item is _DONE:
                done = True
            else:
                tokens.append(item)
                # Coalesce whatever else is already queued — and, once
                # the first (latency-critical) delta is out, keep
                # WAITING until stream_tokens have accumulated or the
                # request finishes, so a response is a few fat messages
                # instead of one per decode step.
                target = self.stream_tokens if first_sent else 1
                while True:
                    try:
                        more = (out.get(timeout=_POLL_S)
                                if len(tokens) < target else
                                out.get_nowait())
                    except queue.Empty:
                        if len(tokens) < target:
                            if not context.is_active():
                                handle.cancel()  # eviction pushes _DONE
                            continue
                        break
                    if more is _DONE:
                        done = True
                        break
                    tokens.append(more)
            if done:
                reason = handle.finish_reason
                span.attrs["outcome"] = reason
                span.attrs["tokens"] = handle.stats["tokens"]
                # How much prefill the prefix cache skipped (0 = miss):
                # the span-level record behind a fast/slow first token.
                span.attrs["prefix_tokens"] = \
                    handle.stats["prefix_tokens"]
                yield pb.GenerateDelta(
                    tokens=tokens, done=True, finish_reason=reason)
                return
            yield pb.GenerateDelta(tokens=tokens)
            first_sent = True


def serve_capabilities(engine: ServeEngine) -> list[str]:
    caps = [
        f"max_batch:{engine.max_batch}",
        f"max_seq:{engine.max_seq}",
        f"queue_depth:{engine.queue_depth}",
        f"vocab:{engine.cfg.vocab}",
        f"kv_page_tokens:{engine.page_tokens}",
        f"kv_pool_pages:{engine._pagepool.n_pages}",
    ]
    if engine._prefix is not None:
        caps.append(f"prefix_block:{engine.prefix_block}")
    if engine.spec_tokens:
        caps.append(f"spec_tokens:{engine.spec_tokens}")
    return caps


def serve_server(
    endpoint: str, service: ServeService, tls: TLSConfig | None = None,
    max_workers: int | None = None,
) -> NonBlockingGRPCServer:
    """Serve the Serve + Identity services on one endpoint (the same
    co-serving shape as every other oim daemon, oim-driver.go:199-207).

    ``max_workers`` bounds CONCURRENT STREAMS, not just in-flight unary
    calls: a streaming Generate holds its executor thread for the whole
    response, so it defaults to enough threads for every decode slot and
    every queued request to stream at once — admission control belongs
    to the engine's bounded queue, not to a starved thread pool."""
    engine = service.engine
    if max_workers is None:
        max_workers = max(16, engine.max_batch + engine.queue_depth + 4)
    identity = IdentityService(
        "oim-serve",
        capabilities=serve_capabilities(engine),
        # Ready = still taking requests; a draining daemon probes false
        # so orchestration stops routing to it before the listener dies.
        ready_fn=lambda: not (engine._draining or engine._stopping),
    )
    server = NonBlockingGRPCServer(
        endpoint, tls=tls, interceptors=(LogServerInterceptor(),),
        max_workers=max_workers,
    )

    def register(s):
        add_serve_to_server(service, s)
        add_identity_to_server(identity, s)

    server.start(register)
    return server
