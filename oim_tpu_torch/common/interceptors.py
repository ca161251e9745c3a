"""gRPC call-logging interceptors with payload formatting and secret stripping.

Re-creates the reference's active tracing layer (pkg/oim-common/tracing.go):
unary interceptors on both client and server log method + payload pre/post
through the context logger, with a pluggable payload formatter. The
``StripSecrets`` formatter redacts any proto field named ``secret`` (the
reference uses csi protosanitizer for the same purpose, tracing.go:53-66).

The port's copy of ``oim_tpu/common/interceptors.py``; ``redact_text``
comes from ``common/redact.py``, which loads without grpcio.
"""

from __future__ import annotations

from typing import Any, Callable

import grpc
from google.protobuf.message import Message

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.redact import _REDACTED, redact_text  # noqa: F401

Formatter = Callable[[Any], str]


class _Lazy:
    """Defers payload formatting until the log line is actually rendered —
    the logger formats fields with !r after its level check, so a disabled
    DEBUG costs nothing (reference delayedFormatter, tracing.go:69-82)."""

    __slots__ = ("_fmt", "_msg")

    def __init__(self, fmt: Formatter, msg: Any):
        self._fmt = fmt
        self._msg = msg

    def __repr__(self) -> str:
        return self._fmt(self._msg)


def complete_formatter(msg: Any) -> str:
    """Log the full payload (reference CompletePayloadFormatter)."""
    if isinstance(msg, Message):
        return str(msg).replace("\n", " ").strip() or "<empty>"
    return repr(msg)


def null_formatter(msg: Any) -> str:
    """Log no payload (reference NullPayloadFormatter)."""
    return "<hidden>"


def strip_secrets(msg: Any) -> str:
    """Redact fields named 'secret' anywhere in the message tree."""
    if not isinstance(msg, Message):
        return repr(msg)
    clone = type(msg)()
    clone.CopyFrom(msg)
    _redact(clone)
    return str(clone).replace("\n", " ").strip() or "<empty>"


_SECRET_FIELDS = ("secret", "secrets")

def _redact(msg: Message) -> None:
    for field, value in msg.ListFields():
        secret = field.name in _SECRET_FIELDS
        if field.type == field.TYPE_MESSAGE:
            entry = field.message_type
            if entry.GetOptions().map_entry:
                # Proto maps present as repeated (key, value) entry
                # messages: iterating the composite yields KEYS, so the
                # old repeated-message recursion never saw the values —
                # map<string,string> secrets passed through unredacted.
                # list() before mutating: writing through a live upb map
                # iterator can invalidate it and silently skip entries
                # (observed as an unredacted secret on loaded suite runs).
                value_field = entry.fields_by_name["value"]
                if secret and value_field.type == value_field.TYPE_STRING:
                    for key in list(value):
                        value[key] = _REDACTED
                elif value_field.type == value_field.TYPE_MESSAGE:
                    for key in list(value):
                        _redact(value[key])
            elif field.is_repeated:
                for item in value:
                    _redact(item)
            else:
                _redact(value)
        elif secret and field.type == field.TYPE_STRING:
            if field.is_repeated:
                # Repeated string secrets: replace every element in place
                # (setattr on a repeated field raises).
                for i in range(len(value)):
                    value[i] = _REDACTED
            else:
                setattr(msg, field.name, _REDACTED)


class LogServerInterceptor(grpc.ServerInterceptor):
    """Log request/response around every unary handler (reference
    LogGRPCServer, tracing.go:101-119)."""

    def __init__(self, formatter: Formatter = strip_secrets):
        self._fmt = formatter

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler
        method = handler_call_details.method
        fmt = self._fmt
        inner = handler.unary_unary

        def wrapped(request, context):
            log = from_context()
            log.debug("handling", method=method, request=_Lazy(fmt, request))
            try:
                reply = inner(request, context)
            except Exception as exc:  # noqa: BLE001 - log then re-raise
                log.debug("failed", method=method, error=str(exc))
                raise
            log.debug("handled", method=method, reply=_Lazy(fmt, reply))
            return reply

        return grpc.unary_unary_rpc_method_handler(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


class LogClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    """Log calls on the client side (reference LogGRPCClient,
    tracing.go:123-141)."""

    def __init__(self, formatter: Formatter = strip_secrets):
        self._fmt = formatter

    def intercept_unary_unary(self, continuation, client_call_details, request):
        log = from_context()
        log.debug(
            "calling",
            method=client_call_details.method,
            request=_Lazy(self._fmt, request),
        )
        return continuation(client_call_details, request)
