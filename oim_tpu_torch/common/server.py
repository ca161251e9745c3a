"""gRPC server harness (reference pkg/oim-common/server.go).

* ``parse_endpoint`` understands ``unix:///path``, ``unix://path``,
  ``tcp://host:port`` and bare ``host:port`` (server.go:28-40).
* ``NonBlockingGRPCServer`` binds (cleaning up stale unix sockets), serves in
  the background, exposes the bound address for ``:0`` port discovery
  (server.go:108-115), and supports graceful and forced stop
  (server.go:117-129).

The port's copy of ``oim_tpu/common/server.py``; it imports nothing of
that package.
"""

from __future__ import annotations

import os
from concurrent import futures
from typing import Callable, Sequence

import grpc

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.tlsutil import (
    GRPC_MAX_MESSAGE_BYTES,
    TLSConfig,
    server_credentials,
)


def parse_endpoint(endpoint: str) -> tuple[str, str]:
    """Return (scheme, address) where scheme is 'unix' or 'tcp'."""
    if endpoint.startswith("unix://"):
        path = endpoint[len("unix://"):]
        if not path:
            raise ValueError(f"invalid endpoint: {endpoint!r}")
        return "unix", path
    if endpoint.startswith("tcp://"):
        addr = endpoint[len("tcp://"):]
        if not addr:
            raise ValueError(f"invalid endpoint: {endpoint!r}")
        return "tcp", addr
    if "://" in endpoint:
        raise ValueError(f"unsupported endpoint scheme: {endpoint!r}")
    if not endpoint:
        raise ValueError("empty endpoint")
    return "tcp", endpoint


class NonBlockingGRPCServer:
    """Background gRPC server with endpoint parsing and lifecycle management."""

    def __init__(
        self,
        endpoint: str,
        tls: TLSConfig | None = None,
        interceptors: Sequence[grpc.ServerInterceptor] = (),
        max_workers: int = 16,
    ):
        # Telemetry wraps outermost on EVERY server (spans + labeled RPC
        # metrics + trace_id-bound logger, common/rpctelemetry.py) so the
        # registry, controller, feeder daemon, and test servers all emit
        # oim_rpc_latency_seconds/oim_rpc_total without per-call wiring.
        from oim_tpu_torch.common.rpctelemetry import TelemetryServerInterceptor

        self._endpoint = endpoint
        self._tls = tls
        self._interceptors = (TelemetryServerInterceptor(), *interceptors)
        self._max_workers = max_workers
        self._server: grpc.Server | None = None
        self._addr: str | None = None
        self._unix_path: str | None = None
        self._on_stop: list[Callable[[], None]] = []

    def add_cleanup(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once when the server stops (graceful or forced) —
        for resources whose lifetime is the server's, like a handler's
        channel pool."""
        self._on_stop.append(fn)

    @property
    def addr(self) -> str:
        """The bound address, usable as a dial target (resolves ':0')."""
        if self._addr is None:
            raise RuntimeError("server not started")
        return self._addr

    def start(
        self,
        register: Callable[[grpc.Server], None],
        options: Sequence[tuple[str, object]] = (),
    ) -> None:
        scheme, address = parse_endpoint(self._endpoint)
        # Raised message caps on every oim server, mirroring dial_options:
        # ReadVolume chunks up to the controller's MAX_READ_CHUNK must
        # clear both ends (and the transparent proxy in between). Caller
        # options append after, so they can override.
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers),
            interceptors=self._interceptors,
            options=[
                ("grpc.max_send_message_length", GRPC_MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE_BYTES),
                *options,
            ],
        )
        register(server)
        if scheme == "unix":
            # Clean up a stale socket from a previous run (server.go:68-75).
            if os.path.exists(address):
                os.unlink(address)
            target = f"unix:{address}"
            self._unix_path = address
            if self._tls is not None:
                server.add_secure_port(target, server_credentials(self._tls))
            else:
                server.add_insecure_port(target)
            self._addr = target
        else:
            if self._tls is not None:
                port = server.add_secure_port(address, server_credentials(self._tls))
            else:
                port = server.add_insecure_port(address)
            if port == 0:
                raise RuntimeError(f"failed to bind {address!r}")
            host = address.rsplit(":", 1)[0]
            if host in ("", "0.0.0.0", "[::]"):
                host = "localhost"
            self._addr = f"{host}:{port}"
        server.start()
        self._server = server
        from_context().info("server listening", endpoint=self._addr)

    def wait(self) -> None:
        assert self._server is not None
        self._server.wait_for_termination()

    def stop(self, grace: float | None = 5.0) -> None:
        """Graceful stop (server.go:117-123)."""
        if self._server is not None:
            self._server.stop(grace).wait()
            self._cleanup()

    def force_stop(self) -> None:
        """Immediate stop (server.go:125-129)."""
        if self._server is not None:
            self._server.stop(None).wait()
            self._cleanup()

    def _cleanup(self) -> None:
        self._server = None
        while self._on_stop:
            self._on_stop.pop()()
        if self._unix_path and os.path.exists(self._unix_path):
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass

    def run(self, register: Callable[[grpc.Server], None]) -> None:
        """start + wait (server.go:131-137)."""
        self.start(register)
        self.wait()
