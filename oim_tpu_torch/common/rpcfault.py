"""The gRPC-status fault of ``oim_tpu/common/faultinject.py``, in a
module of its own: ``faultinject`` loads on a machine without grpcio, and
this class subclasses ``grpc.RpcError``."""

from __future__ import annotations

import grpc


class InjectedRpcError(grpc.RpcError):
    """An armable transport-class fault: carries a real
    ``grpc.StatusCode`` so retry contracts and channel-pool eviction
    (``ChannelPool.maybe_evict``) treat it exactly like the wire. Args
    carry the full state, so per-fire re-instantiation (see
    ``faultinject.fire``) reproduces it faithfully."""

    def __init__(self, code: grpc.StatusCode = grpc.StatusCode.UNAVAILABLE,
                 details: str = "injected fault"):
        super().__init__(code, details)
        self._code = code
        self._details = details

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._details
