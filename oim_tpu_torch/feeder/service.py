"""The feeder daemon's service (``oim_tpu/feeder/service.py``): the
Feeder library served as a long-running node service.

Consumer processes that do not link the feeder (or are not Python)
publish, read and unpublish volumes through ``oim.v1.Feeder``, and learn
the daemon's wiring through ``oim.v1.Identity`` on the same endpoint.
The daemon is ``cli/oim_feeder.py``.
"""

from __future__ import annotations

import grpc

from oim_tpu_torch.common.identity import IdentityService
from oim_tpu_torch.common.interceptors import LogServerInterceptor
from oim_tpu_torch.common.server import NonBlockingGRPCServer
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.controller.controller import ControllerService, array_spec_proto
from oim_tpu_torch.feeder.driver import (
    DeadlineExceeded,
    Feeder,
    PublishError,
    PublishedVolume,
)
from oim_tpu_torch.feeder.emulation import emulations
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import (
    FeederServicer,
    add_feeder_to_server,
    add_identity_to_server,
)

# The controller's own read rules, so the two read paths cannot drift:
# the default chunk clears gRPC's stock 4 MiB message cap, and a chunk a
# client asks for may go up to MAX_READ_CHUNK under the oim channels'
# ceiling.
READ_CHUNK = ControllerService.DEFAULT_READ_CHUNK
MAX_READ_CHUNK = ControllerService.MAX_READ_CHUNK


def _reply_for(pub: PublishedVolume, spec: pb.ArraySpec | None = None) -> pb.PublishVolumeReply:
    reply = pb.PublishVolumeReply(
        placement=pb.HBMPlacement(
            coordinate=pub.coordinate.to_proto(),
            device_id=pub.device_id,
            bytes=pub.bytes,
        ),
        buffer_handle=pub.handle,
    )
    if spec is not None:
        reply.spec.CopyFrom(spec)
    return reply


class FeederDaemon(FeederServicer):
    """oim.v1.Feeder over a Feeder (local or remote mode)."""

    def __init__(self, feeder: Feeder, default_timeout: float = 60.0):
        self.feeder = feeder
        self.default_timeout = default_timeout

    def PublishVolume(self, request, context):
        timeout = request.timeout_seconds or self.default_timeout
        try:
            if request.emulate:
                pub = self.feeder.publish_emulated(
                    request.emulate, request.volume_id, dict(request.attributes),
                    dict(request.secrets), timeout=timeout)
            elif request.HasField("map"):
                pub = self.feeder.publish(request.map, timeout=timeout)
            else:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "need map or emulate+volume_id")
        except ValueError as err:  # unknown emulation / bad attributes
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
        except DeadlineExceeded as err:
            # A client must tell "never staged" from a precondition failure.
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(err))
        except PublishError as err:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(err))
        return _reply_for(pub)

    def UnpublishVolume(self, request, context):
        try:
            self.feeder.unpublish(request.volume_id)
        except PublishError as err:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(err))
        return pb.UnpublishVolumeReply()

    def ListPublished(self, request, context):
        with self.feeder._lock:
            published = list(self.feeder._published.values())
        return pb.ListPublishedReply(published=[_reply_for(p) for p in published])

    def ReadPublished(self, request, context):
        """A ranged data window for daemon clients: read through the
        feeder (which proxies to the controller in remote mode) and cut
        into chunks under the message cap."""
        volume_id = request.volume_id
        offset = int(request.offset)
        length = int(request.length)
        chunk = int(request.chunk_bytes)
        chunk = min(chunk, MAX_READ_CHUNK) if chunk > 0 else READ_CHUNK
        try:
            window, total, spec = self.feeder.fetch_window(
                volume_id, offset, length, timeout=self.default_timeout)
        except PublishError as err:
            code = (grpc.StatusCode.NOT_FOUND if err.code == "NOT_FOUND"
                    else grpc.StatusCode.FAILED_PRECONDITION)
            context.abort(code, str(err))
        if spec is not None and not isinstance(spec, pb.ArraySpec):
            spec = array_spec_proto(spec)  # local mode: the staged volume's spec
        first = True
        end = offset + window.size
        for off in range(offset, end, chunk) if window.size else [offset]:
            stop = min(off + chunk, end)
            msg = pb.ReadVolumeChunk(data=window[off - offset:stop - offset].tobytes(),
                                     offset=off)
            if first:
                if spec is not None:
                    msg.spec.CopyFrom(spec)
                msg.total_bytes = total
                first = False
            yield msg


def feeder_capabilities(feeder: Feeder) -> list[str]:
    caps = [f"emulation:{e}" for e in emulations()]
    caps.append("mode:local" if feeder.controller is not None else "mode:remote")
    if feeder.controller is not None:
        from oim_tpu_torch.controller.controller import controller_capabilities

        caps += controller_capabilities(feeder.controller)
    return caps


def feeder_server(endpoint: str, daemon: FeederDaemon,
                  tls: TLSConfig | None = None) -> NonBlockingGRPCServer:
    """Serve Feeder and Identity on one endpoint."""
    identity = IdentityService("oim-feeder", capabilities=feeder_capabilities(daemon.feeder))
    server = NonBlockingGRPCServer(endpoint, tls=tls, interceptors=(LogServerInterceptor(),))

    def register(s):
        add_feeder_to_server(daemon, s)
        add_identity_to_server(identity, s)

    server.start(register)
    return server
