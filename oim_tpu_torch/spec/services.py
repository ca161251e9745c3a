"""Hand-written gRPC service bindings for the oim.v1 protocol.

Equivalent to what grpc_tools' protoc plugin would generate (the reference commits
its generated bindings too, pkg/spec/oim/v0/oim.pb.go). Kept deliberately thin:
serializer tables + stub/servicer/registration helpers, driven by a declarative
method table so the registry's transparent proxy can share it.
"""

from __future__ import annotations

import grpc

from oim_tpu_torch.spec import oim_pb2 as pb

REGISTRY_SERVICE = "oim.v1.Registry"
CONTROLLER_SERVICE = "oim.v1.Controller"
IDENTITY_SERVICE = "oim.v1.Identity"
FEEDER_SERVICE = "oim.v1.Feeder"
SERVE_SERVICE = "oim.v1.Serve"

# method name -> (request class, reply class)
REGISTRY_METHODS = {
    "SetValue": (pb.SetValueRequest, pb.SetValueReply),
    "GetValues": (pb.GetValuesRequest, pb.GetValuesReply),
    "Heartbeat": (pb.HeartbeatRequest, pb.HeartbeatReply),
    "Vote": (pb.VoteRequest, pb.VoteReply),
    "Ack": (pb.AckRequest, pb.AckReply),
}

REGISTRY_STREAM_METHODS = {
    "Replicate": (pb.ReplicateRequest, pb.ReplicateRecord),
    "Watch": (pb.WatchRequest, pb.WatchEvent),
}

CONTROLLER_METHODS = {
    "MapVolume": (pb.MapVolumeRequest, pb.MapVolumeReply),
    "UnmapVolume": (pb.UnmapVolumeRequest, pb.UnmapVolumeReply),
    "ProvisionMallocBDev": (pb.ProvisionMallocBDevRequest, pb.ProvisionMallocBDevReply),
    "CheckMallocBDev": (pb.CheckMallocBDevRequest, pb.CheckMallocBDevReply),
    "StageStatus": (pb.StageStatusRequest, pb.StageStatusReply),
    "PrestageVolume": (pb.MapVolumeRequest, pb.PrestageVolumeReply),
}

# unary-stream methods (server streams the reply type).
CONTROLLER_STREAM_METHODS = {
    "ReadVolume": (pb.ReadVolumeRequest, pb.ReadVolumeChunk),
}

IDENTITY_METHODS = {
    "GetInfo": (pb.GetInfoRequest, pb.GetInfoReply),
    "Probe": (pb.ProbeRequest, pb.ProbeReply),
}

FEEDER_METHODS = {
    "PublishVolume": (pb.PublishVolumeRequest, pb.PublishVolumeReply),
    "UnpublishVolume": (pb.UnpublishVolumeRequest, pb.UnpublishVolumeReply),
    "ListPublished": (pb.ListPublishedRequest, pb.ListPublishedReply),
}

FEEDER_STREAM_METHODS = {
    "ReadPublished": (pb.ReadVolumeRequest, pb.ReadVolumeChunk),
}

SERVE_METHODS: dict = {}

SERVE_STREAM_METHODS = {
    "Generate": (pb.GenerateRequest, pb.GenerateDelta),
}


class _Stub:
    """Stub over method tables (unary-unary + unary-stream)."""

    _service: str = ""
    _methods: dict = {}
    _stream_methods: dict = {}

    def __init__(self, channel: grpc.Channel):
        for name, (req_cls, reply_cls) in self._methods.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    f"/{self._service}/{name}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=reply_cls.FromString,
                ),
            )
        for name, (req_cls, reply_cls) in self._stream_methods.items():
            setattr(
                self,
                name,
                channel.unary_stream(
                    f"/{self._service}/{name}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=reply_cls.FromString,
                ),
            )


class RegistryStub(_Stub):
    _service = REGISTRY_SERVICE
    _methods = REGISTRY_METHODS
    _stream_methods = REGISTRY_STREAM_METHODS


class ControllerStub(_Stub):
    _service = CONTROLLER_SERVICE
    _methods = CONTROLLER_METHODS
    _stream_methods = CONTROLLER_STREAM_METHODS


class IdentityStub(_Stub):
    _service = IDENTITY_SERVICE
    _methods = IDENTITY_METHODS


class FeederStub(_Stub):
    _service = FEEDER_SERVICE
    _methods = FEEDER_METHODS
    _stream_methods = FEEDER_STREAM_METHODS


class ServeStub(_Stub):
    _service = SERVE_SERVICE
    _methods = SERVE_METHODS
    _stream_methods = SERVE_STREAM_METHODS


class RegistryServicer:
    """Subclass and override; unimplemented methods abort with UNIMPLEMENTED."""

    def SetValue(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "SetValue not implemented")

    def GetValues(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "GetValues not implemented")

    def Heartbeat(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Heartbeat not implemented")

    def Replicate(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Replicate not implemented")

    def Watch(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Watch not implemented")

    def Vote(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Vote not implemented")

    def Ack(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Ack not implemented")


class ControllerServicer:
    def MapVolume(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "MapVolume not implemented")

    def UnmapVolume(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "UnmapVolume not implemented")

    def ProvisionMallocBDev(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "ProvisionMallocBDev not implemented")

    def CheckMallocBDev(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "CheckMallocBDev not implemented")

    def StageStatus(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "StageStatus not implemented")

    def PrestageVolume(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "PrestageVolume not implemented")

    def ReadVolume(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "ReadVolume not implemented")


def _stream_serializer(reply_cls):
    """Response serializer for server-streaming methods that passes
    pre-serialized frames (bytes) through untouched. The Watch hub
    serializes each delta ONCE and fans the shared bytes out to every
    attached stream (registry/watch.py); without the passthrough, the
    gRPC layer would re-serialize per stream and erase the win."""
    serialize = reply_cls.SerializeToString

    def to_wire(message):
        return message if isinstance(message, bytes) else serialize(message)

    return to_wire


def _add_service(
    server: grpc.Server, servicer, service: str, methods: dict,
    stream_methods: dict | None = None,
) -> None:
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=reply_cls.SerializeToString,
        )
        for name, (req_cls, reply_cls) in methods.items()
    }
    for name, (req_cls, reply_cls) in (stream_methods or {}).items():
        handlers[name] = grpc.unary_stream_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=_stream_serializer(reply_cls),
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service, handlers),)
    )


class IdentityServicer:
    def GetInfo(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "GetInfo not implemented")

    def Probe(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Probe not implemented")


class ServeServicer:
    def Generate(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Generate not implemented")


class FeederServicer:
    def PublishVolume(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "PublishVolume not implemented")

    def UnpublishVolume(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "UnpublishVolume not implemented")

    def ListPublished(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "ListPublished not implemented")

    def ReadPublished(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "ReadPublished not implemented")


def add_registry_to_server(servicer: RegistryServicer, server: grpc.Server) -> None:
    _add_service(
        server, servicer, REGISTRY_SERVICE, REGISTRY_METHODS,
        REGISTRY_STREAM_METHODS,
    )


def add_controller_to_server(servicer: ControllerServicer, server: grpc.Server) -> None:
    _add_service(
        server, servicer, CONTROLLER_SERVICE, CONTROLLER_METHODS,
        CONTROLLER_STREAM_METHODS,
    )


def add_identity_to_server(servicer: IdentityServicer, server: grpc.Server) -> None:
    _add_service(server, servicer, IDENTITY_SERVICE, IDENTITY_METHODS)


def add_feeder_to_server(servicer: FeederServicer, server: grpc.Server) -> None:
    _add_service(
        server, servicer, FEEDER_SERVICE, FEEDER_METHODS, FEEDER_STREAM_METHODS
    )


def add_serve_to_server(servicer: ServeServicer, server: grpc.Server) -> None:
    _add_service(
        server, servicer, SERVE_SERVICE, SERVE_METHODS, SERVE_STREAM_METHODS
    )
