"""RPC telemetry: the gRPC interceptors of ``oim_tpu/common/tracing.py``,
in a module of their own.

``TelemetryServerInterceptor`` opens a ``server:<method>`` span around
every handler (unary and streaming), binds its ``trace_id`` into the
context logger, and records ``oim_rpc_latency_seconds{method,code}`` and
``oim_rpc_total{method,code}``; ``TelemetryClientInterceptor`` opens a
``client:<method>`` span, injects ``oim-trace`` into the call metadata and
records the same families when the call completes. ``common/server.py``
prepends the server half to every server, and ``tlsutil.dial`` wraps every
channel with the client half.

They live apart from ``common/tracing.py`` because they subclass ``grpc``
classes: the trainer, the feeds, the backends and the card's smoke script
import ``tracing`` on a machine that has neither grpcio nor protobuf.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Sequence

import grpc

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common import tracing
from oim_tpu_torch.common.logging import from_context, with_logger
from oim_tpu_torch.common.tracing import (
    Span,
    SpanContext,
    _new_span_id,
    _new_trace_id,
    current_context,
    extract,
    inject,
    start_span,
)


def method_label(method: str) -> str:
    """Metric/span label for a full gRPC method path: strip the leading
    slash ("oim.v1.Registry/GetValues")."""
    return method.lstrip("/")


def _observe(method: str, code: str, seconds: float,
             trace_id: str = "") -> None:
    # trace_id rides the latency bucket as an OpenMetrics exemplar: a
    # slow p99 bucket then NAMES a request to pull from /debug/spans
    # and /debug/events instead of pointing at an anonymous aggregate.
    M.RPC_LATENCY.labels(method=method, code=code).observe(
        seconds, exemplar=trace_id)
    M.RPC_TOTAL.labels(method=method, code=code).inc()


def _context_code(context, fallback: str) -> str:
    """The status code a servicer context carries after the handler ran
    (set by abort/set_code), else ``fallback``."""
    get = getattr(context, "code", None)
    if callable(get):
        try:
            code = get()
        except Exception:  # pragma: no cover - non-standard context impls
            code = None
        if code is not None:
            return code.name if hasattr(code, "name") else str(code)
    return fallback


class TelemetryServerInterceptor(grpc.ServerInterceptor):
    """Spans + labeled RPC metrics around every handler — unary and
    streaming, including the registry's generic proxy handler and the
    Replicate journal stream. Runs outermost (common/server.py prepends
    it), so the trace-bound logger is what LogServerInterceptor sees."""

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return handler
        method = method_label(handler_call_details.method)
        parent = extract(handler_call_details.invocation_metadata)

        def wrap_unary(inner):
            def wrapped(request_or_iterator, context):
                t0 = time.monotonic()
                with start_span(f"server:{method}", parent=parent) as span:
                    with with_logger(
                            from_context().with_fields(trace_id=span.trace_id)):
                        try:
                            reply = inner(request_or_iterator, context)
                        except Exception:
                            code = _context_code(context, "UNKNOWN")
                            span.attrs["code"] = code
                            _observe(method, code, time.monotonic() - t0,
                                     span.trace_id)
                            raise
                        code = _context_code(context, "OK")
                        span.attrs["code"] = code
                        _observe(method, code, time.monotonic() - t0,
                                 span.trace_id)
                        return reply
            return wrapped

        def wrap_streaming(inner):
            # The response generator runs lazily in the RPC's serving
            # thread: the span must stay open (and the trace-bound logger
            # attached) until the stream drains, so the wrapper is itself
            # a generator. Metrics then time the whole stream, exactly how
            # go-grpc-prometheus times server-streaming handlers.
            # GeneratorExit matters here: an infinite stream (Replicate)
            # only ever ends by client cancel/disconnect, which arrives as
            # close() on this generator — without catching it those calls
            # would never be counted at all.
            def wrapped(request_or_iterator, context):
                t0 = time.monotonic()
                with start_span(f"server:{method}", parent=parent) as span:
                    with with_logger(
                            from_context().with_fields(trace_id=span.trace_id)):
                        try:
                            yield from inner(request_or_iterator, context)
                        except GeneratorExit:
                            code = _context_code(context, "CANCELLED")
                            span.attrs["code"] = code
                            _observe(method, code, time.monotonic() - t0,
                                     span.trace_id)
                            raise
                        except Exception:
                            code = _context_code(context, "UNKNOWN")
                            span.attrs["code"] = code
                            _observe(method, code, time.monotonic() - t0,
                                     span.trace_id)
                            raise
                        code = _context_code(context, "OK")
                        span.attrs["code"] = code
                        _observe(method, code, time.monotonic() - t0,
                                 span.trace_id)
            return wrapped

        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                wrap_unary(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                wrap_streaming(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.stream_unary:
            return grpc.stream_unary_rpc_method_handler(
                wrap_unary(handler.stream_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.stream_stream:
            return grpc.stream_stream_rpc_method_handler(
                wrap_streaming(handler.stream_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        return handler


class _ClientCallDetails(NamedTuple):
    method: str
    timeout: float | None
    metadata: Sequence[tuple[str, Any]] | None
    credentials: Any
    wait_for_ready: bool | None
    compression: Any


class TelemetryClientInterceptor(
    grpc.UnaryUnaryClientInterceptor,
    grpc.UnaryStreamClientInterceptor,
    grpc.StreamUnaryClientInterceptor,
    grpc.StreamStreamClientInterceptor,
):
    """Client half: opens a ``client:<method>`` span, injects ``oim-trace``
    into the call metadata, and records latency/total labeled by the final
    status code when the call completes (done callback — streaming calls
    finish when the response stream does). tlsutil.dial wraps every
    channel with this, so the feeder, heartbeat loop, replication
    follower, and oimctl all propagate context without code changes."""

    def _start(self, client_call_details):
        method = method_label(client_call_details.method)
        # Begin the span by hand: it must outlive this function (closed in
        # the done callback), which a context manager cannot express.
        # Parent preference: the ambient span, else a context explicitly
        # injected into the call metadata (the proxy's forwarded calls
        # when the ambient contextvar didn't cross threads) — never orphan
        # an explicitly-propagated trace onto a fresh root.
        parent = current_context() or extract(client_call_details.metadata)
        if parent is None:
            ctx = SpanContext(_new_trace_id(), _new_span_id())
            parent_id = ""
        else:
            ctx = SpanContext(parent.trace_id, _new_span_id())
            parent_id = parent.span_id
        span = Span(f"client:{method}", ctx, parent_id)
        md = inject(client_call_details.metadata, ctx)
        details = _ClientCallDetails(
            client_call_details.method,
            client_call_details.timeout,
            md,
            getattr(client_call_details, "credentials", None),
            getattr(client_call_details, "wait_for_ready", None),
            getattr(client_call_details, "compression", None),
        )
        t0 = time.monotonic()

        def finish(code_name: str) -> None:
            span.attrs["code"] = code_name
            span.finish()
            tracing.recorder().record(span)
            _observe(method, code_name, time.monotonic() - t0,
                     span.trace_id)

        return details, finish

    def _intercept(self, continuation, client_call_details, arg):
        details, finish = self._start(client_call_details)
        try:
            call = continuation(details, arg)
        except Exception:
            finish("UNKNOWN")
            raise

        def done(completed_call) -> None:
            try:
                code = completed_call.code()
            except Exception:  # pragma: no cover - cancelled before start
                code = None
            finish(code.name if code is not None else "UNKNOWN")

        call.add_done_callback(done)
        return call

    intercept_unary_unary = _intercept
    intercept_unary_stream = _intercept
    intercept_stream_unary = _intercept
    intercept_stream_stream = _intercept
