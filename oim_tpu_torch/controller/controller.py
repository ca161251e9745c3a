"""Controller service + lifecycle (``oim_tpu/controller/controller.py``)
over the port's ``CUDABackend`` and ``MallocBackend``.

* ``ControllerService`` implements the oim.v1.Controller RPCs with per-volume
  keyed locking (controller.go:44-51) and strict idempotency: re-mapping an
  existing volume with identical params returns the existing placement
  (controller.go:96-125); unmapping an unknown volume succeeds
  (controller.go:202-209).
* ``Controller`` wraps the service with the health-plane loop (the
  reference's self-registration loop, controller.go:411-476, upgraded to
  leases): a background thread registers ``<id>/address`` and ``<id>/mesh``
  with a lease TTL, then HEARTBEATS every ``registry_delay`` seconds to renew
  it over ONE pooled channel (common/channelpool.py — the reference's fresh
  channel per attempt, README.md:138-143, paid a TLS handshake per renewal;
  the pool evicts on UNAVAILABLE and re-dials on recovery). ``known == false`` in a
  heartbeat reply (registry restarted, lease swept) triggers an immediate
  full re-registration; registry outages back off exponentially with jitter
  so a restarting registry isn't thundering-herded by the fleet; a registry
  without the Heartbeat RPC degrades to the reference's plain re-register-
  every-delay loop.

The torch edge: requests arrive as the wire's protobuf messages and the
backends take the port's dataclasses (``spec.ArraySpec``,
``spec.FileParams``, ...), converted here (``array_spec``,
``volume_params``). The idempotency fingerprint stays the request's
deterministic serialization, so ``ALREADY_EXISTS`` fires where the JAX
service's does. ``StageStatus`` is built from ``StagedVolume.status()``,
and ``ReadVolume`` streams ``backend.read_window``: only the window's
bytes leave the device, through a ``uint8`` view, and the first chunk's
spec carries the numpy-style dtype name and the global shape.
"""

from __future__ import annotations

import threading
import time

import grpc

from oim_tpu_torch import spec as S
from oim_tpu_torch.common import channelpool, faultinject
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.backoff import ExponentialBackoff
from oim_tpu_torch.common.endpoints import FAILOVER_CODES, RegistryEndpoints
from oim_tpu_torch.common.interceptors import LogServerInterceptor
from oim_tpu_torch.common.keymutex import KeyMutex
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.common.pathutil import REGISTRY_ADDRESS, REGISTRY_MESH
from oim_tpu_torch.common.server import NonBlockingGRPCServer
from oim_tpu_torch.common.tlsutil import TLSConfig, peer_common_name
from oim_tpu_torch.controller.backend import (
    StagedVolume,
    StageState,
    StagingBackend,
    array_shape,
    dtype_name,
    read_window,
    volume_nbytes,
)
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import (
    ControllerServicer,
    RegistryStub,
    add_controller_to_server,
)


def array_spec(msg) -> S.ArraySpec:
    """The port's ArraySpec of a wire ``pb.ArraySpec``."""
    return S.ArraySpec(shape=tuple(int(d) for d in msg.shape), dtype=msg.dtype,
                       sharding_axes=tuple(msg.sharding_axes))


def array_spec_proto(spec: S.ArraySpec) -> pb.ArraySpec:
    return pb.ArraySpec(shape=list(spec.shape), dtype=spec.dtype,
                        sharding_axes=list(spec.sharding_axes))


def volume_params(kind: str, msg):
    """The port's params dataclass of a MapVolumeRequest's ``params``
    oneof member."""
    if kind == "file":
        return S.FileParams(path=msg.path, format=msg.format)
    if kind == "tfrecord":
        return S.TFRecordParams(paths=tuple(msg.paths))
    if kind == "webdataset":
        return S.WebDatasetParams(shard_urls=tuple(msg.shard_urls))
    if kind == "ceph":
        return S.CephParams(monitors=msg.monitors, user=msg.user, secret=msg.secret,
                            pool=msg.pool, image=msg.image)
    if kind == "malloc":
        return S.MallocParams()
    raise ValueError(f"unknown params kind {kind!r}")


class ControllerService(ControllerServicer):
    def __init__(self, backend: StagingBackend, controller_id: str = ""):
        self.backend = backend
        # Own identity, for the direct-path peer check (_authorize_data):
        # "" (bare test/local services) disables enforcement.
        self.controller_id = controller_id
        self._volumes: dict[str, StagedVolume] = {}
        self._vol_lock = threading.Lock()
        self._keymutex = KeyMutex()

    # -- helpers ----------------------------------------------------------

    def _authorize_data(self, context, rpc: str) -> None:
        """The ``host.<id>`` -> ``<id>`` rule, bound on the DIRECT path
        — for EVERY controller RPC (a direct UnmapVolume is at least as
        dangerous as a direct ReadVolume).

        The transparent proxy enforces that only controller <id>'s
        assigned host may reach it — but PR 5's direct data path dials
        the controller straight, where mTLS alone admits ANY CA-signed
        peer (the CA-domain-only hole in doc/architecture.md's security
        note). So the controller re-checks its caller itself: the
        assigned host (``host.<own id>``), the registry's proxy hop
        (``component.registry`` — the registry already applied the host
        rule to the ORIGINAL caller before forwarding), or an operator
        (``user.admin``). Enforcement needs a verified peer, so it binds
        exactly when the transport authenticated one (mTLS); insecure
        deployments have no CN to check — same condition the proxy uses.
        """
        if not self.controller_id:
            return
        if not hasattr(context, "auth_context"):
            return  # in-process call (Feeder._LocalContext): no transport
        peer = peer_common_name(context)
        if peer is None:  # insecure/unauthenticated transport
            return
        if peer not in (f"host.{self.controller_id}",
                        "component.registry", "user.admin"):
            context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"{peer!r} may not {rpc} on controller "
                f"{self.controller_id!r}",
            )

    def get_volume(self, volume_id: str) -> StagedVolume | None:
        with self._vol_lock:
            return self._volumes.get(volume_id)

    def _placement(self, volume: StagedVolume) -> pb.MapVolumeReply:
        coord = MeshCoord()
        coord_of = getattr(self.backend, "coord_of", None)
        if coord_of is not None:
            coord = coord_of(volume)
        return pb.MapVolumeReply(
            placement=pb.HBMPlacement(
                coordinate=coord.to_proto(),
                device_id=volume.device_id,
                bytes=volume.bytes_staged,
            ),
            spec=array_spec_proto(volume.spec),
            buffer_handle=volume.volume_id,
        )

    # -- RPCs -------------------------------------------------------------

    def MapVolume(self, request, context):
        self._authorize_data(context, "MapVolume")
        if not request.volume_id:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty volume_id")
        params_kind = request.WhichOneof("params")
        if not params_kind:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "no volume params")
        params_key = request.SerializeToString(deterministic=True)
        with self._keymutex.locked(request.volume_id):
            existing = self.get_volume(request.volume_id)
            if existing is not None:
                if existing.params_key != params_key:
                    context.abort(
                        grpc.StatusCode.ALREADY_EXISTS,
                        f"volume {request.volume_id!r} mapped with different params",
                    )
                if existing.state != StageState.FAILED:
                    return self._placement(existing)
                # A FAILED volume must not poison its volume_id: evict it and
                # fall through to a fresh staging attempt, so retries can
                # succeed once the underlying fault clears.
                with self._vol_lock:
                    self._volumes.pop(request.volume_id, None)
                self.backend.unstage(existing)
            volume = StagedVolume(
                volume_id=request.volume_id,
                params_key=params_key,
                spec=array_spec(request.spec),
            )
            with self._vol_lock:
                self._volumes[request.volume_id] = volume
            self.backend.stage(volume, params_kind,
                               volume_params(params_kind, getattr(request, params_kind)))
            from_context().info(
                "mapping volume", volume=request.volume_id, kind=params_kind
            )
            return self._placement(volume)

    def UnmapVolume(self, request, context):
        self._authorize_data(context, "UnmapVolume")
        if not request.volume_id:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty volume_id")
        with self._keymutex.locked(request.volume_id):
            with self._vol_lock:
                volume = self._volumes.pop(request.volume_id, None)
            if volume is not None:
                # unstage is race-free against an in-flight stager: it sets
                # volume.cancelled under the condition lock and the stager
                # frees its own array if it loses the race (mark_ready=False).
                self.backend.unstage(volume)
                from_context().info("unmapped volume", volume=request.volume_id)
            return pb.UnmapVolumeReply()

    def ProvisionMallocBDev(self, request, context):
        self._authorize_data(context, "ProvisionMallocBDev")
        if not request.bdev_name:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty bdev_name")
        if request.size < 0:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "negative size")
        with self._keymutex.locked(request.bdev_name):
            try:
                self.backend.provision(request.bdev_name, request.size)
            except ValueError as err:
                context.abort(grpc.StatusCode.ALREADY_EXISTS, str(err))
            return pb.ProvisionMallocBDevReply()

    def CheckMallocBDev(self, request, context):
        self._authorize_data(context, "CheckMallocBDev")
        if not request.bdev_name:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty bdev_name")
        if not self.backend.check(request.bdev_name):
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"no bdev {request.bdev_name!r}"
            )
        return pb.CheckMallocBDevReply()

    def StageStatus(self, request, context):
        self._authorize_data(context, "StageStatus")
        volume = self.get_volume(request.volume_id)
        if volume is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"no volume {request.volume_id!r}"
            )
        status = volume.status()
        return pb.StageStatusReply(ready=status.ready, bytes_staged=status.bytes_staged,
                                   gbps=status.gbps, error=status.error)

    def PrestageVolume(self, request, context):
        """Warm the backend's content-addressed stage cache for the
        request's source WITHOUT creating a volume (the warm-standby
        path, spec.md PrestageVolume): an async stage runs into the
        cache, so a later MapVolume of identical content hits in O(1).
        Idempotent and volume-table-free — prestaging never conflicts
        with a mapped volume_id."""
        self._authorize_data(context, "PrestageVolume")
        params_kind = request.WhichOneof("params")
        if not params_kind:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "no volume params")
        backend = self.backend
        prestage = getattr(backend, "prestage", None)
        content_key = getattr(backend, "_content_key", None)
        if prestage is None or content_key is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "backend has no stage cache",
            )
        params = volume_params(params_kind, getattr(request, params_kind))
        spec = array_spec(request.spec)
        keyinfo = content_key(params_kind, params, spec)
        if keyinfo is None:
            # Mutable (malloc) / unfingerprintable sources can never be
            # served from the cache: a warm would pay the full O(volume)
            # stage and throw it away. Refuse instead of pretending.
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{params_kind} source is not content-addressable; "
                "nothing to prestage",
            )
        # Resident already? (Pure probe: lookup pins, so release the pin.)
        entry = backend.cache.lookup(keyinfo[0])
        if entry is not None:
            backend.cache.release(entry, keep=True)
            return pb.PrestageVolumeReply(already_cached=True)
        prestage(params_kind, params, spec)
        from_context().info(
            "prestaging volume", volume=request.volume_id, kind=params_kind
        )
        return pb.PrestageVolumeReply(already_cached=False)

    # Default chunk when the client doesn't ask: leaves headroom under
    # gRPC's stock 4 MiB max message size, so even a consumer that dialed
    # without the raised oim caps (tests, third-party stubs) can stream.
    DEFAULT_READ_CHUNK = 3 << 20
    # Cap for a client-REQUESTED chunk_bytes: feeders that dialed through
    # tlsutil (GRPC_MAX_MESSAGE_BYTES = 32 MiB on both ends) pull big
    # windows in a few large messages instead of dozens of 3 MiB ones.
    # 16 MiB + first-chunk framing clears the 32 MiB cap with margin.
    MAX_READ_CHUNK = 16 << 20

    def ReadVolume(self, request, context):
        """Stream a staged volume back to a cross-process consumer — the
        data window of remote mode (spec.md ReadVolume; the vhost-user
        shared-memory analog, reference README.md:153-170)."""
        self._authorize_data(context, "ReadVolume")
        volume = self.get_volume(request.volume_id)
        if volume is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"no volume {request.volume_id!r}"
            )
        if volume.state != StageState.READY:
            code = (
                grpc.StatusCode.FAILED_PRECONDITION
                if volume.state == StageState.STAGING
                else grpc.StatusCode.INTERNAL
            )
            context.abort(code, f"volume {request.volume_id!r}: {volume.state.value}"
                          + (f" ({volume.error})" if volume.error else ""))
        arr = volume.array
        total = volume_nbytes(arr)
        start = int(request.offset)
        if start < 0 or start > total:
            context.abort(grpc.StatusCode.OUT_OF_RANGE, f"offset {start}")
        end = total if request.length == 0 else min(start + int(request.length), total)
        # Materialize only the requested range: read_window slices in
        # element space before the copy, so the device->host transfer (and
        # host memory) stays at window size, not volume size.
        try:
            raw_win, _ = read_window(arr, start, end - start)
        except ValueError as err:  # a rank's slice of a mesh-placed volume
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"volume {request.volume_id!r}: {err}")
        chunk = int(request.chunk_bytes)
        # Non-positive = "not asked" (a negative value must not clamp to
        # 1-byte chunks and stream a window as millions of messages).
        chunk = min(chunk, self.MAX_READ_CHUNK) if chunk > 0 \
            else self.DEFAULT_READ_CHUNK
        first = True
        for off in range(start, end, chunk) if start < end else [start]:
            stop = min(off + chunk, end)
            data = raw_win[off - start:stop - start].tobytes()
            msg = pb.ReadVolumeChunk(data=data, offset=off)
            if request.accept_compressed and data:
                # Negotiated per-stream: only a client that declared it
                # can decompress ever receives compressed bytes, and
                # only when compression actually shrinks the chunk
                # (cold KV/weight extents squeeze well; random-ish
                # tensors don't — those ship raw). Level 1: the wire is
                # the bottleneck this exists for, not CPU.
                import zlib

                packed = zlib.compress(data, 1)
                if len(packed) < len(data):
                    msg.data = packed
                    msg.compressed = True
            if first:
                msg.spec.CopyFrom(array_spec_proto(volume.spec))
                msg.spec.dtype = msg.spec.dtype or dtype_name(arr.dtype)
                if not msg.spec.shape:
                    msg.spec.shape.extend(array_shape(arr))
                msg.total_bytes = total
                first = False
            yield msg


class Controller:
    """Service + heartbeat loop + server wiring (controller.go:379-495)."""

    # Default lease TTL as a multiple of the heartbeat interval: one lost
    # heartbeat must not expire a healthy controller, two-and-a-half do.
    LEASE_FACTOR = 2.5
    # Backoff bounds for registry outages (seconds). The base also scales
    # down with registry_delay so short-interval test rigs retry promptly.
    BACKOFF_MAX = 30.0

    def __init__(
        self,
        controller_id: str,
        backend: StagingBackend,
        controller_address: str = "",
        registry_address: str = "",
        registry_delay: float = 60.0,
        lease_seconds: float = 0.0,
        mesh_coord: MeshCoord | None = None,
        tls: TLSConfig | None = None,
        pool: channelpool.ChannelPool | None = None,
        extra_lease_keys: list[str] | None = None,
    ):
        if registry_address and not controller_address:
            raise ValueError("registration requires a controller address")
        self.controller_id = controller_id
        self.service = ControllerService(backend, controller_id=controller_id)
        self.controller_address = controller_address
        # ``registry_address`` may be a comma-separated endpoint list
        # (primary,standby): the heartbeat loop fails over to the next
        # endpoint when the current one is down or answers standby.
        self.registry_address = registry_address
        # With no registry configured, keep the pre-list behavior for
        # direct register_once()/heartbeat_once() callers: dialing ""
        # fails as an RpcError at call time (start() never runs the loop).
        self._endpoints = RegistryEndpoints(
            registry_address if registry_address else [""])
        self.registry_delay = registry_delay
        # 0 = derive from the heartbeat interval; < 0 = no lease (register
        # permanent entries — the pre-health-plane behavior).
        if lease_seconds == 0.0:
            lease_seconds = self.LEASE_FACTOR * registry_delay
        self.lease_seconds = max(lease_seconds, 0.0)
        self.mesh_coord = mesh_coord
        self.tls = tls
        self._pool = pool if pool is not None else channelpool.shared()
        # Extra leased rows this daemon owns (its telemetry/<id> row),
        # renewed in the SAME Heartbeat round-trip — the batch-heartbeat
        # path. A pre-batch registry silently ignores them (their own
        # publisher loops keep them alive); a batch-aware registry
        # makes one controller heartbeat renew every row the daemon
        # holds.
        self.extra_lease_keys = list(extra_lease_keys or [])
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- heartbeat loop ----------------------------------------------------

    def _registry_channel(self) -> grpc.Channel:
        """The POOLED channel to the current registry endpoint: the
        heartbeat loop renews a lease every registry_delay seconds for
        the process lifetime — the single worst per-call-dial churn in
        the control plane (a TLS handshake per renewal, forever). A dead
        endpoint's channel is evicted by the loop's error path and
        re-dialed on recovery."""
        return self._pool.get(
            self._endpoints.current(), self.tls, "component.registry")

    def _evict_registry_channel(self, err: Exception) -> None:
        self._pool.maybe_evict(err, self._endpoints.current())

    def register_once(self) -> None:
        """One full registration (address + mesh, with lease) over the
        pooled channel (controller.go:448-468, minus its per-call dial)."""
        faultinject.fire("controller.register", controller_id=self.controller_id)
        stub = RegistryStub(self._registry_channel())
        try:
            stub.SetValue(
                pb.SetValueRequest(
                    value=pb.Value(
                        path=f"{self.controller_id}/{REGISTRY_ADDRESS}",
                        value=self.controller_address,
                        lease_seconds=self.lease_seconds,
                    )
                ),
                timeout=10.0,
            )
            if self.mesh_coord is not None:
                stub.SetValue(
                    pb.SetValueRequest(
                        value=pb.Value(
                            path=f"{self.controller_id}/{REGISTRY_MESH}",
                            value=self.mesh_coord.format(),
                            lease_seconds=self.lease_seconds,
                        )
                    ),
                    timeout=10.0,
                )
        except grpc.RpcError as err:
            self._evict_registry_channel(err)
            raise

    def heartbeat_once(self) -> bool:
        """One lease renewal over the pooled channel. Returns the
        registry's ``known`` verdict (False = it lost our registration;
        re-register). Raises grpc.RpcError with UNIMPLEMENTED against a
        pre-lease registry (the caller degrades to plain
        re-registration)."""
        faultinject.fire("controller.heartbeat", controller_id=self.controller_id)
        stub = RegistryStub(self._registry_channel())
        try:
            t0 = time.monotonic()
            reply = stub.Heartbeat(
                pb.HeartbeatRequest(
                    controller_id=self.controller_id,
                    lease_seconds=self.lease_seconds,
                    keys=self.extra_lease_keys,
                ),
                timeout=10.0,
            )
            M.HEARTBEAT_RTT.set(time.monotonic() - t0)
            return reply.known
        except grpc.RpcError as err:
            self._evict_registry_channel(err)
            raise

    def start(self) -> None:
        """Begin the register-then-heartbeat loop (controller.go:411-446,
        plus lease renewal and jittered-backoff outage recovery)."""
        if not self.registry_address:
            return

        def loop() -> None:
            log = from_context().with_fields(controller=self.controller_id)
            registered = False
            heartbeat_supported = True
            # Jittered exponential backoff (common/backoff.py): a
            # restarting registry must not be hit by the whole fleet in
            # lockstep. The base scales down with registry_delay so
            # short-interval test rigs retry promptly.
            backoff = ExponentialBackoff(
                base=min(1.0, self.registry_delay), cap=self.BACKOFF_MAX)
            while not self._stop.is_set():
                try:
                    if not registered or not heartbeat_supported:
                        self.register_once()
                        registered = True
                        log.debug("registered", registry=self.registry_address,
                                  lease_s=self.lease_seconds)
                    else:
                        if not self.heartbeat_once():
                            # Registry forgot us (restart / swept lease):
                            # re-register NOW, not one interval from now.
                            log.warning("lease lost; re-registering")
                            registered = False
                            continue
                        log.debug("heartbeat", registry=self.registry_address)
                    backoff.reset()
                except (grpc.RpcError, faultinject.InjectedFault) as err:
                    if (isinstance(err, grpc.RpcError)
                            and err.code() == grpc.StatusCode.UNIMPLEMENTED
                            and heartbeat_supported):
                        # Pre-lease registry: degrade to the reference's
                        # plain re-register-every-delay loop.
                        heartbeat_supported = False
                        log.warning(
                            "registry has no Heartbeat RPC; falling back to "
                            "periodic re-registration"
                        )
                        continue
                    detail = (err.details() or str(err.code())
                              if isinstance(err, grpc.RpcError) else str(err))
                    if (self._endpoints.multiple
                            and isinstance(err, grpc.RpcError)
                            and err.code() in FAILOVER_CODES):
                        # Replicated registry: UNAVAILABLE (endpoint dead)
                        # or FAILED_PRECONDITION (unpromoted standby /
                        # quorum follower) — jump to the leader the
                        # rejection named, else rotate, and let the
                        # backoff below pace the retry.
                        if not self._endpoints.apply_hint(err):
                            self._endpoints.advance()
                        target = self._endpoints.current()
                        log.warning("failing over to peer registry",
                                    target=target)
                    delay = backoff.next()
                    log.warning(
                        "registry unreachable; backing off",
                        error=detail, attempt=backoff.failures,
                        retry_s=round(delay, 3),
                    )
                    # Conservatively assume the lease may lapse during the
                    # outage: re-register (idempotent) on recovery.
                    registered = False
                    if self._stop.wait(delay):
                        return
                    continue
                if self._stop.wait(self.registry_delay):
                    return

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def controller_capabilities(service: ControllerService) -> list[str]:
    """Capability strings for the Identity service: the staging backend
    (MallocBackend -> "backend:malloc", CUDABackend -> "backend:cuda") plus
    every source kind load_source accepts."""
    from oim_tpu_torch.controller.source import SOURCES

    backend = getattr(service, "backend", None)
    if backend is None:  # mock controllers in tests
        return []
    name = type(backend).__name__.removesuffix("Backend").lower()
    return [f"backend:{name}"] + [f"source:{s}" for s in SOURCES]


def controller_server(
    endpoint: str, service: ControllerService, tls: TLSConfig | None = None
) -> NonBlockingGRPCServer:
    """Serve a controller + its Identity service on one endpoint
    (controller.go:479-495; identity co-serving per oim-driver.go:199-207);
    also used by tests to serve mocks."""
    from oim_tpu_torch.common.identity import IdentityService
    from oim_tpu_torch.spec.services import add_identity_to_server

    identity = IdentityService(
        "oim-controller", capabilities=controller_capabilities(service)
    )
    server = NonBlockingGRPCServer(
        endpoint, tls=tls, interceptors=(LogServerInterceptor(),)
    )

    def register(s):
        add_controller_to_server(service, s)
        add_identity_to_server(identity, s)

    server.start(register)
    return server
