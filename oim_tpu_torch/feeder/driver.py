"""Feeder driver (``oim_tpu/feeder/driver.py``): the NodePublishVolume
path, for the port.

Reference flow (pkg/oim-csi-driver/nodeserver.go:76-310): lock by volume name,
idempotency check, read the controller's default PCI address from the registry,
MapVolume through the registry proxy with ``controllerid`` metadata, merge the
returned PCI address with the registry default, wait for the kernel block
device, mount. Here: lock, idempotency check, read the ``<id>/mesh`` default,
MapVolume (direct in local mode, through the proxy in remote mode), merge mesh
coordinates, wait for the device copy via StageStatus, and hand back the
staged array handle.

Two mutually exclusive modes, validated at construction like the reference's
``New`` (oim-driver.go:174-184): **local** (an in-process ControllerService —
the SPDK-socket mode analog, and the production trainer configuration where
controller and trainer share one process) and **remote** (registry address
+ controller ID + TLS — data lands in the remote controller's runtime; the
feeder sees placement metadata and polls readiness).

In the port the staged array is a torch tensor (on a card, or the host)
or a ``plane.Placed``: local mode reads it through
``controller.backend.read_window``, which copies only a window's bytes
off the device, never ``np.asarray`` of a device tensor. ``fetch`` gives
a numpy array of the volume's dtype, and refuses bfloat16, which numpy
lacks (``fetch_window`` gives its bytes).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from typing import Any, Mapping

import grpc

import numpy as np

from oim_tpu_torch.common import channelpool, events, faultinject, rpcfault, tracing
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.backoff import DecorrelatedJitter
from oim_tpu_torch.common.endpoints import RegistryEndpoints
from oim_tpu_torch.common.keymutex import KeyMutex
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.common.pathutil import (
    CONTROLLER_ID_META,
    REGISTRY_ADDRESS,
    REGISTRY_MESH,
)
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.controller.backend import dtype_name, numpy_dtype, read_window
from oim_tpu_torch.controller.controller import ControllerService
from oim_tpu_torch.feeder.emulation import map_volume_params
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import ControllerStub, RegistryStub


class PublishError(Exception):
    """Publish/window failure. ``code`` carries the gRPC status name
    ("UNAVAILABLE", "NOT_FOUND", ...) where one exists — recovery logic
    (fetch_window heal) branches on it, never on message text, so a
    reworded error can't silently disable healing and an unrelated error
    whose text mentions a status name can't trigger it."""

    def __init__(self, message: str, code: str = ""):
        super().__init__(message)
        self.code = code


class DeadlineExceeded(PublishError):
    """Staging did not materialize before the deadline (the analog of the
    reference's device-wait hitting its context deadline,
    nodeserver.go:348-351)."""


class _WindowStalled(grpc.RpcError):
    """A window stream that delivered nothing for STALL_CANCEL_S: the
    transport's termination event was lost (the endpoint died but the
    blocked read never learned). Shaped as a transport-class
    UNAVAILABLE so the existing fallback ladder — proxy, then
    controller failover — heals it like any other dead endpoint."""

    def __init__(self, details: str):
        super().__init__(details)
        self._details = details

    def code(self) -> grpc.StatusCode:
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return self._details


@dataclasses.dataclass
class PublishedVolume:
    volume_id: str
    coordinate: MeshCoord
    device_id: int
    bytes: int
    handle: str
    array: Any = None  # populated in local mode
    params_key: bytes = b""  # request fingerprint for idempotency checks
    request: Any = None  # the original MapVolumeRequest (heal re-publish)


class _AddressWatch:
    """Push-fed resolver for ONE controller's ``<id>/address`` key.

    PR 14's named follow-up: the feeder's direct-path resolver was the
    last point-to-point GetValues poll in the data plane — every
    DIRECT_TTL_S per feeder, fleet-wide. This rides one Watch stream on
    the single address key instead (a full registry path is a valid
    prefix), so an address move or lease expiry reaches the resolver
    the moment it commits, and steady state issues ZERO reads. The poll
    survives untouched as the fallback: pre-Watch registry
    (UNIMPLEMENTED retires the thread permanently), stream down, or not
    yet synced — ``value()`` returns None and the caller's existing
    GetValues path takes over. ``retarget`` re-scopes the stream after
    a controller failover."""

    def __init__(self, feeder: "Feeder"):
        self._feeder = feeder
        self._lock = threading.Lock()
        self._controller_id = feeder.controller_id
        self._value = ""  # the live address, "" = no live row
        self._synced = False
        self._unsupported = False
        self._call = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="oim-feeder-address-watch", daemon=True)
        self._thread.start()

    def value(self) -> str | None:
        """The pushed live address; "" when the stream proves there is
        no live row (lease expired / deleted — the proxy fast-fail
        signal); None when the stream cannot answer (fall back to the
        poll)."""
        with self._lock:
            if self._unsupported or not self._synced:
                return None
            return self._value

    def usable(self) -> bool:
        with self._lock:
            return not self._unsupported

    def retarget(self, controller_id: str) -> None:
        """Point the stream at a new controller's address key (feeder
        failover): cancel the current call; the loop re-opens scoped to
        the new key with a fresh snapshot."""
        with self._lock:
            self._controller_id = controller_id
            self._synced = False
            self._value = ""
            call = self._call
        if call is not None:
            call.cancel()

    def _watch_once(self) -> None:
        from oim_tpu_torch.feeder.watch import WatchConsumer

        with self._lock:
            cid = self._controller_id
        key = f"{cid}/{REGISTRY_ADDRESS}"
        stub = RegistryStub(self._feeder._registry_channel())
        consumer = WatchConsumer()

        def is_current(path: str) -> bool:
            with self._lock:
                return path == f"{self._controller_id}/{REGISTRY_ADDRESS}"

        def install(rows: dict) -> None:
            with self._lock:
                self._value = rows.get(
                    f"{self._controller_id}/{REGISTRY_ADDRESS}", "")

        def put(path: str, value: str) -> None:
            if is_current(path):
                with self._lock:
                    self._value = value

        def delete(path: str, expired: bool) -> None:
            if is_current(path):
                with self._lock:
                    self._value = ""

        def on_sync() -> None:
            with self._lock:
                # A retarget between open and sync scoped this stream to
                # the OLD key: its view must not be trusted for the new.
                if self._controller_id == cid:
                    self._synced = True

        def on_reset() -> None:
            with self._lock:
                self._synced = False

        call = stub.Watch(pb.WatchRequest(path=key))
        with self._lock:
            self._call = call
        try:
            consumer.run(call, install=install, put=put, delete=delete,
                         on_reset=on_reset, on_sync=on_sync,
                         is_stopped=self._stop.is_set)
        finally:
            with self._lock:
                self._call = None
                self._synced = False

    def _loop(self) -> None:
        from oim_tpu_torch.common.backoff import ExponentialBackoff, jittered

        backoff = ExponentialBackoff(base=0.2, cap=10.0)
        while not self._stop.is_set():
            try:
                self._watch_once()
                backoff.reset()
                delay = jittered(0.2)
            except grpc.RpcError as err:
                if err.code() == grpc.StatusCode.UNIMPLEMENTED:
                    with self._lock:
                        self._unsupported = True
                    events.emit(events.WATCH_RESYNC,
                                consumer="feeder_resolver",
                                reason="pre-watch registry: poll mode")
                    return
                delay = backoff.next()
            except Exception:  # noqa: BLE001 - resolver must not die
                delay = backoff.next()
            if self._stop.wait(delay):
                return

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            call = self._call
        if call is not None:
            call.cancel()
        self._thread.join(timeout=5.0)


class Feeder:
    # StageStatus poll pacing: decorrelated jitter from POLL_BASE_S,
    # capped at POLL_CAP_S (well under any practical publish deadline).
    POLL_BASE_S = 0.002
    POLL_CAP_S = 0.25
    # Direct-endpoint cache TTL: the feeder re-reads the registry's LIVE
    # (lease-filtered) view at most this often per volume, so a
    # controller whose lease lapsed — or whose address moved — stops
    # being dialed directly within one TTL even when its channel happens
    # to stay up. Failures invalidate immediately; this bounds the
    # silent-staleness window only.
    DIRECT_TTL_S = 30.0
    # Preferred ReadVolume chunk size requested from the server (the
    # server clamps to its MAX_READ_CHUNK): big windows stream in a few
    # large messages instead of dozens of 3 MiB ones.
    WINDOW_CHUNK_BYTES = 16 << 20
    # Deadline for the first-use probe of a freshly (re)dialed direct
    # channel: a registered-but-unroutable endpoint (firewalled pod IP —
    # TCP may connect but nothing speaks gRPC) HANGS instead of
    # refusing, and this bounds that failure mode on the probe instead
    # of on the window read itself, which gets the caller's full
    # remaining budget. Verified channels (WeakSet) skip the probe, so
    # steady state pays zero extra RPCs.
    DIRECT_PROBE_TIMEOUT_S = 5.0
    # A window READ's DEADLINE_EXCEEDED only arms the one-TTL direct
    # back-off when the deadline that expired was at least this long: a
    # sub-second read budget (heal loop near its deadline) missing is
    # evidence about the BUDGET, not the endpoint, and must not pin
    # later well-budgeted windows to the proxy for 30s. The 1-byte
    # PROBE is different — it should complete in milliseconds, so
    # missing ANY deadline is endpoint evidence and always arms
    # (otherwise a tight-budget feed against a black-holed endpoint
    # would re-pay the probe hang on every single window).
    BACKOFF_MIN_DEADLINE_S = 1.0
    # A ReadVolume stream that delivers NOTHING for this long is
    # locally cancelled (see _read_window's stall belt): chunks arrive
    # back-to-back from a healthy server, so two silent windows of this
    # means the transport's termination event was lost, not that the
    # stream is slow. Generous on purpose — a legitimately slow stream
    # is bounded by the RPC deadline, not by this.
    STALL_CANCEL_S = 10.0

    def __init__(
        self,
        controller: ControllerService | None = None,
        registry_address: str = "",
        controller_id: str = "",
        tls: TLSConfig | None = None,
        warm_standby: bool = False,
        direct_data: bool = True,
        window_chunk_bytes: int = 0,
        window_compress: bool = False,
        pool: channelpool.ChannelPool | None = None,
    ):
        local = controller is not None
        remote = bool(registry_address or controller_id)
        if local == remote:
            raise ValueError(
                "exactly one of local (controller=) or remote "
                "(registry_address= + controller_id=) mode required"
            )
        if remote and not (registry_address and controller_id):
            raise ValueError("remote mode needs registry_address and controller_id")
        self.controller = controller
        # Comma-separated endpoint list (primary,standby): operations
        # rotate to the next endpoint when the current registry is down
        # or answers standby (registry-level failover, distinct from the
        # controller-level _fail_over below).
        self.registry_address = registry_address
        self._endpoints = (
            RegistryEndpoints(registry_address) if registry_address else None
        )
        self.controller_id = controller_id
        self.tls = tls
        # Remote mode: after each successful publish, ask the live replica
        # controller at the same mesh coordinate (the one _fail_over would
        # elect) to PrestageVolume the same content — a later failover's
        # re-publish then hits the replica's stage cache in O(1) instead
        # of re-staging O(volume) from source.
        self.warm_standby = warm_standby
        # Remote mode data plane: resolve the owning controller's DIRECT
        # endpoint from the registry topology and stream ReadVolume
        # straight to it — the registry proxy stays the fallback (first
        # contact, direct-dial failure, direct_data=False). The control
        # plane (MapVolume/StageStatus/UnmapVolume) always rides the
        # proxy: the registry owns routing and authorization there.
        self.direct_data = direct_data
        if window_chunk_bytes < 0:
            raise ValueError(
                f"window_chunk_bytes must be positive (0 = default "
                f"{self.WINDOW_CHUNK_BYTES}), got {window_chunk_bytes}")
        self.window_chunk_bytes = window_chunk_bytes or self.WINDOW_CHUNK_BYTES
        # Opt-in wire compression for window reads (--window-compress):
        # the request declares this client can decompress, the server
        # compresses only chunks that actually shrink, and either side
        # predating the field degrades to raw bytes (negotiated
        # per-stream, mixed versions interop). Off by default — cold
        # KV/weight extents over a thin wire are the case it pays for.
        self.window_compress = bool(window_compress)
        self._pool = pool if pool is not None else channelpool.shared()
        # (pinned controller's address, resolved_at monotonic) — one entry:
        # the direct endpoint is a property of the controller, not of any
        # volume. _direct_retry_at > now suppresses the direct path after
        # a deadline-class failure (see _fetch_window_once).
        self._direct_addr: tuple[str, float] | None = None
        self._direct_retry_at = 0.0
        # Push-fed address resolver (one Watch stream on the pinned
        # controller's address key), started lazily by the first direct
        # resolution; None until then, and permanently poll-mode against
        # a pre-Watch registry. _AddressWatch reads the feeder's pool /
        # endpoints / tls through _registry_channel.
        self._address_watch: _AddressWatch | None = None
        # Channels that have answered at least one RPC: first use of a
        # (re)dialed direct channel is probed (hang insurance), verified
        # ones are not. Weak so an evicted channel's entry dies with it.
        self._direct_verified: "weakref.WeakSet[grpc.Channel]" = (
            weakref.WeakSet())
        self._published: dict[str, PublishedVolume] = {}
        self._lock = threading.Lock()
        self._keymutex = KeyMutex()

    # -- plumbing ---------------------------------------------------------

    def _registry_channel(self) -> grpc.Channel:
        """The pooled channel to the endpoint list's current pick (one
        persistent channel per registry endpoint, not the reference's
        fresh DialRegistry per operation — oim-driver.go:219-232 — whose
        per-window TLS handshake the direct data path exists to kill)."""
        return self._pool.get(
            self._endpoints.current(), self.tls, "component.registry")

    def _fire_rpc_fault(self, method: str) -> None:
        """Fault point for the remote data plane: an armed ``feeder.rpc``
        presents as the controller answering UNAVAILABLE — the frozen/dead
        controller scenario, injected deterministically."""
        try:
            faultinject.fire(
                "feeder.rpc", controller_id=self.controller_id, method=method
            )
        except faultinject.InjectedFault as err:
            raise PublishError(
                f"UNAVAILABLE: injected {method} fault", code="UNAVAILABLE"
            ) from err

    def _default_mesh(self, registry: RegistryStub) -> MeshCoord:
        reply = registry.GetValues(
            pb.GetValuesRequest(path=f"{self.controller_id}/{REGISTRY_MESH}"),
            timeout=10.0,
        )
        for value in reply.values:
            try:
                return MeshCoord.parse(value.value)
            except ValueError:
                pass
        return MeshCoord()

    # -- failure recovery: re-resolve + failover ---------------------------

    def _registry_entries(self, include_stale: bool = False) -> dict[str, str]:
        address = self._endpoints.current()
        try:
            reply = RegistryStub(self._registry_channel()).GetValues(
                pb.GetValuesRequest(path="", include_stale=include_stale),
                timeout=10.0,
            )
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            raise
        return {v.path: v.value for v in reply.values}

    def _failover_target(self) -> str | None:
        """A LIVE controller registered at the same mesh coordinate as the
        (presumed dead) pinned one, or None.

        The dead controller's coordinate comes from the stale registry
        view — its lease has typically expired, which is exactly why we
        are here — and candidates from the live view, so a controller
        whose own lease lapsed is never elected. A controller with no
        registered mesh coordinate has no provable replica, so no
        failover (placing data at an unknown coordinate would be worse
        than failing)."""
        try:
            live = self._registry_entries()
            stale = self._registry_entries(include_stale=True)
        except grpc.RpcError:
            return None  # registry itself unreachable; the caller backs off
        mesh_key = f"{self.controller_id}/{REGISTRY_MESH}"
        if mesh_key not in stale:
            return None
        try:
            coord = MeshCoord.parse(stale[mesh_key])
        except ValueError:
            return None
        for path in sorted(live):
            cid, _, key = path.partition("/")
            if cid == self.controller_id or key != REGISTRY_MESH:
                continue
            try:
                same = MeshCoord.parse(live[path]) == coord
            except ValueError:
                continue
            if same and live.get(f"{cid}/{REGISTRY_ADDRESS}"):
                return cid
        return None

    def _fail_over(self, volume_id: str, reason: str) -> bool:
        """Re-target the feeder to a healthy replica of the pinned
        controller's mesh coordinate. Returns False when none exists.
        The switch alone suffices: per-RPC re-resolution (fresh proxy
        dial per operation) picks up the new id, and a volume missing on
        the replica restages through the NOT_FOUND heal path using
        MapVolume's documented idempotency."""
        target = self._failover_target()
        if target is None:
            return False
        from_context().warning(
            "failing over to replica controller",
            volume=volume_id, dead=self.controller_id, target=target,
            reason=reason,
        )
        M.FEEDER_FAILOVERS.inc()
        events.emit(events.FEEDER_FAILOVER, volume=volume_id,
                    dead=self.controller_id, target=target, reason=reason)
        self.controller_id = target
        # The direct-endpoint cache is per PINNED controller: it points
        # at the dead one's address now — and so does any armed direct
        # back-off, which must not pin windows to the proxy for a TTL
        # against the healthy replacement. The address watch re-scopes
        # its stream to the new controller's key.
        self._direct_addr = None
        self._direct_retry_at = 0.0
        if self._address_watch is not None:
            self._address_watch.retarget(target)
        return True

    def prestage_replica(self, request: pb.MapVolumeRequest) -> str | None:
        """Best-effort warm of the failover candidate's stage cache
        (remote mode): sends PrestageVolume for ``request`` to a LIVE
        controller serving the same mesh coordinate as the pinned one —
        exactly the controller _fail_over would elect. Returns the warmed
        controller id, or None when no replica exists or the RPC failed
        (warming is advisory: failures never affect the publish)."""
        if self.controller is not None:
            return None
        # _failover_target works for a live pinned controller too: its
        # coordinate comes from the include_stale view, which contains
        # live entries as well.
        target = self._failover_target()
        if target is None:
            return None
        address = self._endpoints.current()
        try:
            faultinject.fire("prestage.fanout",
                             volume=request.volume_id, target=target)
            ControllerStub(self._registry_channel()).PrestageVolume(
                request,
                metadata=[(CONTROLLER_ID_META, target)],
                timeout=30.0,
            )
            from_context().info(
                "warmed standby stage cache",
                volume=request.volume_id, target=target,
            )
            return target
        except (faultinject.InjectedFault, rpcfault.InjectedRpcError):
            # Warming is advisory: an injected fan-out failure (like a
            # real one) must never fail the publish it rode along with.
            # InjectedRpcError is caught HERE, not by the RpcError
            # branch below: it never touched the wire, so it must not
            # evict the healthy pooled registry channel.
            from_context().warning(
                "standby prestage fault-injected",
                volume=request.volume_id, target=target,
            )
            return None
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            from_context().warning(
                "standby prestage failed",
                volume=request.volume_id, target=target,
                error=err.code().name,
            )
            return None

    class _LocalContext:
        """Adapts grpc abort() to exceptions for in-process calls."""

        def abort(self, code, details):
            raise PublishError(f"{code.name}: {details}", code=code.name)

    # -- the NodePublishVolume analog --------------------------------------

    def publish(
        self,
        request: pb.MapVolumeRequest,
        timeout: float = 30.0,
    ) -> PublishedVolume:
        if not request.volume_id:
            raise PublishError("empty volume_id")
        params_key = request.SerializeToString(deterministic=True)
        # Root (or caller-nested) span for the whole publish: MapVolume,
        # the StageStatus poll loop, and any failover retries all become
        # its children, so "which hop ate the budget" reads off one trace.
        with tracing.start_span("feeder.publish", volume=request.volume_id), \
                self._keymutex.locked(request.volume_id):
            existing = self._published.get(request.volume_id)
            if existing is not None:
                # Idempotency: already published (nodeserver.go:95-109) —
                # but only for the SAME request. A conflicting re-publish
                # must fail loudly, not silently hand back the old volume
                # (the controller enforces this across clients; the local
                # cache must not mask it).
                if existing.params_key != params_key:
                    raise PublishError(
                        f"volume {request.volume_id!r} already published "
                        "with different params"
                    )
                return existing
            deadline = time.monotonic() + timeout
            if self.controller is not None:
                published = self._publish_local(request, deadline)
            else:
                published = self._publish_remote_with_failover(
                    request, deadline)
            published.params_key = params_key
            published.request = request
            with self._lock:
                self._published[request.volume_id] = published
            from_context().info(
                "published volume",
                volume=request.volume_id,
                coord=published.coordinate.format(),
                bytes=published.bytes,
            )
            if self.warm_standby and self.controller is None:
                threading.Thread(
                    target=self.prestage_replica, args=(request,),
                    daemon=True,
                ).start()
            return published

    def publish_emulated(
        self,
        emulate: str,
        volume_id: str,
        attributes: Mapping[str, str],
        secrets: Mapping[str, str] | None = None,
        timeout: float = 30.0,
    ) -> PublishedVolume:
        """Publish via an emulation personality (reference --emulate flow,
        nodeserver.go:239-247)."""
        return self.publish(
            map_volume_params(emulate, volume_id, attributes, secrets), timeout
        )

    def _publish_remote_with_failover(self, request, deadline):
        """Remote publish with the two recovery layers in preference
        order: (1) registry-level failover — rotate to the standby
        endpoint and retry, which restages nothing because the controller
        is untouched; (2) controller-level retry-with-re-resolve — if a
        live replica serves the same mesh coordinate, publish there
        (MapVolume is idempotent, so a replica that already holds the
        volume just returns its placement). Neither applies -> the
        original fast failure stands."""
        try:
            return self._publish_remote(request, deadline)
        except PublishError as err:
            # Rotation on UNAVAILABLE only: every feeder registry RPC is a
            # read or a proxied controller call, both of which a standby
            # serves — so a FAILED_PRECONDITION here is controller-origin
            # and rotating on it would just repeat the work elsewhere.
            # (Write-path clients — controller heartbeats, oimctl,
            # bootstrap — rotate on the full FAILOVER_CODES set.)
            if err.code == "UNAVAILABLE" and self._endpoints.multiple:
                target = self._endpoints.advance()
                from_context().warning(
                    "publish failing over to peer registry",
                    volume=request.volume_id, target=target, reason=str(err))
                try:
                    return self._publish_remote(request, deadline)
                except PublishError as err2:
                    err = err2
            if err.code != "UNAVAILABLE" or not self._fail_over(
                    request.volume_id, reason=str(err)):
                raise err
            return self._publish_remote(request, deadline)

    def _publish_local(self, request, deadline) -> PublishedVolume:
        reply = self.controller.MapVolume(request, self._LocalContext())
        volume = self.controller.get_volume(request.volume_id)
        if volume is None:
            # Concurrently unmapped between MapVolume and here.
            raise PublishError(f"volume {request.volume_id!r} vanished during publish")
        if not volume.wait(timeout=deadline - time.monotonic()):
            raise DeadlineExceeded(f"staging {request.volume_id!r} timed out")
        if volume.error:
            raise PublishError(volume.error)
        reply = self.controller.MapVolume(request, self._LocalContext())
        coord = MeshCoord.from_proto(reply.placement.coordinate)
        return PublishedVolume(
            volume_id=request.volume_id,
            coordinate=coord,
            device_id=reply.placement.device_id,
            bytes=reply.placement.bytes,
            handle=reply.buffer_handle,
            array=volume.array,
        )

    def _publish_remote(self, request, deadline) -> PublishedVolume:
        address = self._endpoints.current()
        channel = self._registry_channel()
        registry = RegistryStub(channel)
        # The proxy routes Controller methods by metadata
        # (nodeserver.go:230-251).
        stub = ControllerStub(channel)
        metadata = [(CONTROLLER_ID_META, self.controller_id)]
        self._fire_rpc_fault("MapVolume")
        try:
            # Inside the RpcError-to-PublishError wrapper: a dead
            # registry must surface as code=UNAVAILABLE so the
            # endpoint-list failover in the caller can rotate.
            default_coord = self._default_mesh(registry)
            reply = stub.MapVolume(
                request,
                metadata=metadata,
                timeout=deadline - time.monotonic(),
            )
            # Wait for materialization (the waitForDevice analog,
            # nodeserver.go:325-366): poll StageStatus until ready. Every
            # RPC is bounded by the caller's remaining deadline.
            def remaining() -> float:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise DeadlineExceeded(
                        f"staging {request.volume_id!r} timed out"
                    )
                return rem

            # Decorrelated-jitter pacing (common/backoff.py; capped
            # well under any sane deadline): a fast stage is noticed
            # in ~ms instead of a fixed 50 ms quantum, a long one is
            # polled gently, and a fleet of feeders never beats on the
            # controller in lockstep. The histogram makes publish
            # latency spent in this loop attributable from /metrics
            # alone.
            wait_t0 = time.monotonic()
            poll = DecorrelatedJitter(self.POLL_BASE_S, self.POLL_CAP_S)
            try:
                while True:
                    status = stub.StageStatus(
                        pb.StageStatusRequest(volume_id=request.volume_id),
                        metadata=metadata,
                        timeout=remaining(),
                    )
                    if status.error:
                        raise PublishError(status.error)
                    if status.ready:
                        break
                    time.sleep(min(poll.next(), remaining()))
            finally:
                M.STAGE_WAIT_SECONDS.observe(time.monotonic() - wait_t0)
            reply = stub.MapVolume(
                request, metadata=metadata, timeout=remaining()
            )  # refresh placement with final byte count
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            if err.code() == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise DeadlineExceeded(err.details()) from err
            raise PublishError(
                f"{err.code().name}: {err.details()}",
                code=err.code().name,
            ) from err
        # Merge returned coordinate with the registry default, exactly
        # CompletePCIAddress (nodeserver.go:253-273, pci.go:51-65).
        coord = MeshCoord.from_proto(reply.placement.coordinate).complete(
            default_coord
        )
        return PublishedVolume(
            volume_id=request.volume_id,
            coordinate=coord,
            device_id=reply.placement.device_id,
            bytes=reply.placement.bytes,
            handle=reply.buffer_handle,
        )

    # -- data window --------------------------------------------------------

    def fetch(self, volume_id: str, timeout: float = 120.0):
        """The staged volume's data as a host numpy array.

        Local mode: the live array, zero-copy from the shared runtime.
        Remote mode: the whole-volume window — ReadVolume direct to the
        owning controller when resolvable, through the registry proxy
        otherwise, assembled without a join copy (_fetch_window_once).
        """
        if self.controller is not None:
            volume = self.controller.get_volume(volume_id)
            if volume is None:
                raise PublishError(f"no volume {volume_id!r}", code="NOT_FOUND")
            arr = volume.array
            dtype = numpy_dtype(dtype_name(arr.dtype))
            raw, _ = read_window(arr, 0, 0)
            return raw.view(dtype).reshape(tuple(arr.shape))
        raw, _, spec = self._fetch_window_once(volume_id, 0, 0, timeout)
        if spec is None:
            return raw
        arr = raw.view(numpy_dtype(spec.dtype))
        shape = tuple(int(d) for d in spec.shape)
        return arr.reshape(shape) if shape else arr

    # gRPC status codes (PublishError.code — never message text) that heal
    # treats as control-plane transients worth retrying or restaging.
    # FAILED_PRECONDITION covers two transients: a standby registry that
    # has not promoted yet (rotate endpoints), and a volume still STAGING
    # after a heal re-publish (plain backoff-retry).
    RECOVERABLE = ("UNAVAILABLE", "NOT_FOUND", "FAILED_PRECONDITION")

    def fetch_window(self, volume_id: str, offset: int = 0, length: int = 0,
                     timeout: float = 120.0, heal: bool = False):
        """A byte range of the staged volume: (uint8 array, total_bytes,
        ArraySpec). length == 0 means "to the end".

        The windowed form of fetch(): a consumer whose working set is
        smaller than the volume streams windows instead of materializing
        the whole thing host-side (the data window stays bounded the way
        the reference bounds SCSI targets, controller.go:127-148).

        Remote mode serves the window CONTROLLER-DIRECT over a pooled
        channel when the registry topology resolves the owning
        controller's endpoint (direct_data=True, the default); the
        registry proxy is the always-correct fallback — first contact,
        direct-dial failure, or ``Feeder(direct_data=False)``. Which path
        served it is recorded on the span (``path=direct|proxy``) and in
        ``oim_window_path_total``.

        ``heal=True`` makes the window survive control-plane failures
        within ``timeout``: transient UNAVAILABLE (registry/controller
        restarting) retries with backoff — rotating to the peer registry
        endpoint first when a list was configured, because a registry-only
        outage needs no restaging at all — and a NOT_FOUND after a
        controller restart — soft state lost — re-publishes the recorded
        MapVolumeRequest (idempotent; restages from the source) and
        retries. This is the trainer-feed path's recovery primitive: the
        same stance as the reference's re-registration loop, applied to
        the data window (SURVEY.md section 5.3).
        """
        with tracing.start_span("feeder.window", volume=volume_id,
                                offset=offset, length=length, heal=heal):
            if not heal:
                return self._fetch_window_once(
                    volume_id, offset, length, timeout)
            return self._fetch_window_healed(
                volume_id, offset, length, timeout)

    def _fetch_window_healed(self, volume_id: str, offset: int, length: int,
                             timeout: float):
        deadline = time.monotonic() + timeout
        delay = 0.2
        just_failed_over = False
        just_rotated_registry = False
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"window of {volume_id!r} unavailable for {timeout}s")
            try:
                return self._fetch_window_once(
                    volume_id, offset, length, remaining)
            except DeadlineExceeded:
                raise
            except PublishError as err:
                if err.code not in self.RECOVERABLE:
                    raise
                if err.code == "NOT_FOUND":
                    # The controller restarted and lost its soft state:
                    # restage from the recorded request (idempotent).
                    with self._lock:
                        pub = self._published.pop(volume_id, None)
                    if pub is None or pub.request is None:
                        raise
                    try:
                        self.publish(
                            pub.request,
                            timeout=max(deadline - time.monotonic(), 1.0),
                        )
                        from_context().info(
                            "healed volume after controller restart",
                            volume=volume_id,
                        )
                        events.emit(events.VOLUME_HEALED, volume=volume_id,
                                    controller=self.controller_id)
                        continue  # retry the window immediately
                    except (PublishError, grpc.RpcError):
                        # Registry may itself be down mid-heal (raw
                        # RpcError from the pre-publish topology read):
                        # restore the cache entry — losing it would make
                        # the volume permanently unhealable — and keep
                        # backing off toward the deadline.
                        with self._lock:
                            self._published.setdefault(volume_id, pub)
                elif (err.code == "UNAVAILABLE"
                        and not just_rotated_registry
                        and self._endpoints is not None
                        and self._endpoints.multiple):
                    # Registry-level failover first: if only the registry
                    # host died, the standby proxies the SAME controller —
                    # the window completes without restaging anything.
                    # UNAVAILABLE only: the window is a READ, which a
                    # standby serves too, so a FAILED_PRECONDITION here is
                    # controller-origin (volume still STAGING after a heal
                    # re-publish) and must take the backoff path below,
                    # not ping-pong the endpoint cursor.
                    target = self._endpoints.advance()
                    from_context().warning(
                        "window failing over to peer registry",
                        volume=volume_id, target=target, reason=str(err))
                    just_rotated_registry = True
                    continue
                elif (err.code == "UNAVAILABLE" and not just_failed_over
                        and self._fail_over(volume_id, reason=str(err))):
                    # UNAVAILABLE with a live replica at the same mesh
                    # coordinate: re-target and retry immediately. The
                    # replica answers NOT_FOUND if it never staged this
                    # volume, which the branch above heals by re-publish
                    # — restaging from source on the new controller.
                    # Consecutive failovers pace through the backoff
                    # below: two dead replicas pinned as each other's
                    # candidates must not ping-pong in a busy loop.
                    just_failed_over = True
                    continue
                time.sleep(min(delay, max(deadline - time.monotonic(), 0)))
                delay = min(delay * 2, 5.0)
                just_failed_over = False
                just_rotated_registry = False

    def _direct_endpoint(self, budget: float = 10.0) -> str | None:
        """The pinned controller's directly-dialable address, from the
        registry's LIVE (lease-filtered) view, cached for DIRECT_TTL_S.
        A PREFIX read of exactly the one address key — never the whole
        registry dump — so resolution stays O(1) on the data hot path.
        None when direct data is disabled or backing off after a
        deadline-class failure, when the registry is unreachable
        (first-contact: the proxy call will surface the real error), or
        when the controller's lease has expired (the key vanishes from
        the live view; the proxy fast-fails those — the direct path must
        not outlive the lease)."""
        if not self.direct_data:
            return None
        now = time.monotonic()
        if now < self._direct_retry_at:
            return None
        # Push path first (PR 14's follow-up): a synced Watch stream on
        # the address key answers from memory — zero registry reads on
        # the steady-state data path, and an address move or lease
        # expiry lands the moment it commits instead of up to one TTL
        # late. Unsynced/unsupported streams fall through to the
        # original GetValues poll below.
        watch = self._address_watch
        if watch is None:
            # Under self._lock: concurrent first windows (the fetch
            # threads) must not each start a watch — the loser's thread
            # and server-side stream would leak for the process life.
            with self._lock:
                watch = self._address_watch
                if watch is None:
                    watch = self._address_watch = _AddressWatch(self)
        if watch.usable():
            pushed = watch.value()
            if pushed is not None:
                if not pushed:
                    # The stream PROVES no live row: lease expired or
                    # deleted — the direct path must not outlive it.
                    self._direct_addr = None
                    return None
                self._direct_addr = (pushed, now)
                return pushed
        cached = self._direct_addr
        if cached is not None and now - cached[1] < self.DIRECT_TTL_S:
            return cached[0]
        key = f"{self.controller_id}/{REGISTRY_ADDRESS}"
        address = self._endpoints.current()
        if budget <= 0:
            return None
        try:
            # Clamped to the caller's window budget: resolution must
            # never overshoot the deadline the read itself lives under.
            reply = RegistryStub(self._registry_channel()).GetValues(
                pb.GetValuesRequest(path=key), timeout=min(10.0, budget))
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            return None
        resolved = next(
            (v.value for v in reply.values if v.path == key), "")
        if not resolved:
            self._direct_addr = None
            return None
        self._direct_addr = (resolved, now)
        return resolved

    def _read_window(self, channel, volume_id: str, offset: int, length: int,
                     timeout: float):
        """One ReadVolume stream off ``channel`` (direct or proxy),
        assembled zero-copy: the first chunk's total_bytes sizes ONE
        preallocated bytearray, every chunk lands in a memoryview slice
        at its offset, and np.frombuffer wraps the buffer — no
        join-the-parts copy, so one full window allocation is gone from
        the training-feed hot loop. Raises grpc.RpcError raw — the
        caller owns eviction/fallback policy."""

        call = ControllerStub(channel).ReadVolume(
            pb.ReadVolumeRequest(
                volume_id=volume_id, offset=offset, length=length,
                chunk_bytes=self.window_chunk_bytes,
                accept_compressed=self.window_compress,
            ),
            metadata=[(CONTROLLER_ID_META, self.controller_id)],
            timeout=timeout,
        )
        # Stall belt over the transport deadline: when the serving
        # endpoint dies mid-stream, the C core's termination event
        # (goaway / deadline-expired) is occasionally lost (seen under
        # this gVisor sandbox) and a blocked read then waits forever —
        # past any RPC deadline, and a local call.cancel() can itself
        # block inside the wedged core. So the blocking iteration runs
        # on an ABANDONABLE pump thread and the consumer takes chunks
        # through a queue with a no-progress timeout: a silent stream
        # becomes a transport-class UNAVAILABLE the fallback ladder
        # already heals (proxy, then failover), while the abandoned
        # daemon pump costs one parked thread in a case that previously
        # hung the data path outright. Progress resets the clock, so a
        # big window streaming slowly is bounded by the RPC deadline
        # alone, never by STALL_CANCEL_S.
        chunks: queue.Queue = queue.Queue(maxsize=2)
        abandoned = threading.Event()
        _EOS = object()

        def _put(item) -> bool:
            # Bounded-queue put that notices an abandoned consumer: a
            # consumer that raised (stall, bad chunk) stops draining,
            # and a plain put() would park this pump thread forever
            # with the call — and its server-side stream — alive.
            while not abandoned.is_set():
                try:
                    chunks.put(item, timeout=1.0)
                    return True
                except queue.Full:
                    continue
            return False

        def _pump() -> None:
            try:
                for item in call:
                    if not _put(item):
                        return
                _put(_EOS)
            except BaseException as err:  # noqa: BLE001 - relayed
                _put(err)

        def _abandon() -> None:
            # Best-effort teardown off-thread (cancel may block in the
            # same wedged core the stall belt exists to survive).
            abandoned.set()
            threading.Thread(target=call.cancel, daemon=True).start()

        threading.Thread(
            target=_pump, daemon=True, name="oim-window-pump").start()
        buf = None
        view = None
        spec = None
        total = 0
        end_rel = 0
        try:
            while True:
                try:
                    chunk = chunks.get(timeout=self.STALL_CANCEL_S)
                except queue.Empty:
                    stalled = _WindowStalled(
                        f"window stream of {volume_id!r} delivered "
                        f"nothing for {self.STALL_CANCEL_S:.0f}s")
                    stalled.oim_bytes_received = end_rel
                    raise stalled from None
                if chunk is _EOS:
                    break
                if isinstance(chunk, BaseException):
                    # Annotate how far the stream got before failing:
                    # the caller's deadline policy distinguishes "no
                    # bytes ever arrived" (stalled endpoint) from "a
                    # large window was still streaming fine when the
                    # caller's budget ran out".
                    chunk.oim_bytes_received = end_rel
                    raise chunk
                if spec is None and chunk.HasField("spec"):
                    spec = chunk.spec
                if buf is None:
                    # First chunk: total_bytes bounds the window exactly
                    # the way the server computes it.
                    total = int(chunk.total_bytes)
                    end = total if length == 0 else min(
                        offset + length, total)
                    buf = bytearray(max(end - offset, 0))
                    view = memoryview(buf)
                if chunk.data:
                    data = chunk.data
                    if getattr(chunk, "compressed", False):
                        # Only ever set when this request declared
                        # accept_compressed; offsets stay in
                        # uncompressed byte space, so the placement
                        # math below is unchanged.
                        import zlib

                        data = zlib.decompress(data)
                    rel = int(chunk.offset) - offset
                    view[rel:rel + len(data)] = data
                    end_rel = max(end_rel, rel + len(data))
        except BaseException:
            # EVERY consumer exit that leaves the pump running must
            # abandon it (cancel the RPC, release the put loop) — a
            # malformed chunk raising out of the copy above would
            # otherwise leak the pump thread and its open server-side
            # stream. Relayed pump errors and stalls included: cancel
            # on a finished call is a no-op.
            _abandon()
            raise
        if buf is None:  # stream yielded nothing (cancelled mid-setup)
            buf = bytearray()
        raw = np.frombuffer(buf, dtype=np.uint8)
        if end_rel != len(buf):
            # Defensive: a server that streamed short must not hand the
            # consumer uninitialized tail bytes as data.
            raw = raw[:end_rel]
        return raw, total, spec

    def _record_window(self, path: str, nbytes: int, seconds: float) -> None:
        M.WINDOW_PATH_TOTAL.labels(path=path).inc()
        if seconds > 0:
            # Exemplar: a slow-throughput bucket names the window's trace.
            M.WINDOW_GBPS.observe(nbytes / seconds / 1e9,
                                  exemplar=tracing.trace_id())
        span = tracing.current()
        if span is not None:
            span.attrs["path"] = path

    def _direct_transport_failure(self, code, arm_backoff: bool,
                                  volume_id: str, direct: str,
                                  what: str) -> None:
        """Shared bookkeeping for a transport-class direct failure: drop
        the channel and the cached endpoint, and — when the caller's
        ``arm_backoff`` says the expired deadline is evidence about the
        ENDPOINT rather than the budget (see BACKOFF_MIN_DEADLINE_S) —
        arm the one-TTL back-off that keeps subsequent windows off the
        stalled direct path."""
        self._pool.evict(direct)
        self._direct_addr = None
        # A failed direct dial is evidence the PUSHED view may be stale
        # (an address re-registered out of band of the stream): force
        # the watch to resync from a fresh snapshot rather than keep
        # serving the address that just failed.
        if self._address_watch is not None:
            self._address_watch.retarget(self.controller_id)
        if code == grpc.StatusCode.DEADLINE_EXCEEDED and arm_backoff:
            self._direct_retry_at = time.monotonic() + self.DIRECT_TTL_S
        from_context().warning(
            f"direct {what} failed; falling back to proxy",
            volume=volume_id, endpoint=direct, code=code.name,
        )

    def _direct_channel_usable(self, channel, direct: str, volume_id: str,
                               timeout: float) -> bool:
        """Hang insurance for the direct path, paid once per (re)dialed
        channel: a registered-but-unroutable endpoint (firewalled pod
        IP) HANGS instead of refusing, so an unprobed channel's first
        contact is a 1-byte ReadVolume bounded at
        min(DIRECT_PROBE_TIMEOUT_S, timeout/2) — the window read itself
        then gets the caller's FULL remaining budget (a legitimately
        slow large window must not lose half its time to insurance).
        A refused endpoint (UNAVAILABLE: dead port, restarted
        controller) keeps fail-fast semantics — evict and fall through
        to the proxy with NO back-off, so the next window re-resolves
        and goes direct again; only a hang (the probe deadline) arms
        the one-TTL back-off. An ANSWERED status (NOT_FOUND, ...)
        verifies the channel too: the real read will surface the same
        verdict."""
        if channel in self._direct_verified:
            return True
        probe_timeout = min(self.DIRECT_PROBE_TIMEOUT_S, timeout / 2)
        try:
            list(ControllerStub(channel).ReadVolume(
                pb.ReadVolumeRequest(
                    volume_id=volume_id, offset=0, length=1),
                metadata=[(CONTROLLER_ID_META, self.controller_id)],
                timeout=probe_timeout,
            ))
        except grpc.RpcError as err:
            code = err.code()
            if code in (grpc.StatusCode.UNAVAILABLE,
                        grpc.StatusCode.CANCELLED,
                        grpc.StatusCode.DEADLINE_EXCEEDED):
                self._direct_transport_failure(
                    code, True, volume_id, direct, "endpoint probe")
                return False
        self._direct_verified.add(channel)
        return True

    def _fetch_window_once(self, volume_id: str, offset: int, length: int,
                           timeout: float):
        if self.controller is not None:
            volume = self.controller.get_volume(volume_id)
            if volume is None:
                raise PublishError(f"no volume {volume_id!r}", code="NOT_FOUND")
            # Only the window crosses device->host (read_window slices in
            # element space first): copying the whole tensor back per
            # window is the exact cost windowing exists to avoid.
            raw, total = read_window(volume.array, offset, length)
            return raw, total, volume.spec
        self._fire_rpc_fault("ReadVolume")
        # t_start tracks the caller's BUDGET (resolution + read + any
        # fallback all spend it); per-path throughput is timed separately
        # so the occasional TTL-expiry registry round trip never lands in
        # the data histogram as a slow window.
        t_start = time.monotonic()
        deadline = t_start + timeout
        direct = self._direct_endpoint(budget=timeout)
        usable = False
        if direct is not None and deadline - time.monotonic() > 0:
            channel = self._pool.get(
                direct, self.tls, f"controller.{self.controller_id}")
            usable = self._direct_channel_usable(
                channel, direct, volume_id, deadline - time.monotonic())
        read_budget = deadline - time.monotonic()
        if usable and read_budget > 0:
            t0 = time.monotonic()
            try:
                result = self._read_window(
                    channel, volume_id, offset, length, read_budget)
                self._record_window(
                    "direct", result[0].size, time.monotonic() - t0)
                return result
            except grpc.RpcError as err:
                # Transport-class failures fall THROUGH to the proxy —
                # the first rung of the heal ladder, inside one call:
                # UNAVAILABLE (dead/refusing endpoint, fails fast) and
                # CANCELLED (the pooled channel was retired under us).
                # DEADLINE_EXCEEDED splits on stream progress: a stream
                # that WAS moving bytes is a healthy endpoint outrun by
                # the caller's budget — surface the deadline honestly
                # rather than evicting a good channel to re-move the
                # same bytes over the strictly slower two-hop proxy —
                # while zero bytes received means the endpoint went
                # silent after verification: treat it like a probe hang
                # (evict + back off). Anything else means the
                # controller ANSWERED (NOT_FOUND, OUT_OF_RANGE...): the
                # proxy would return the identical verdict, so surface
                # it — the heal ladder branches on the code, not the
                # path.
                code = err.code()
                if (code == grpc.StatusCode.DEADLINE_EXCEEDED
                        and getattr(err, "oim_bytes_received", 0) > 0):
                    raise DeadlineExceeded(
                        f"direct window of {volume_id!r} was still "
                        f"streaming when the {timeout:.1f}s budget ran out"
                    ) from err
                if code not in (
                        grpc.StatusCode.UNAVAILABLE,
                        grpc.StatusCode.CANCELLED,
                        grpc.StatusCode.DEADLINE_EXCEEDED):
                    raise PublishError(
                        f"{code.name}: {err.details()}",
                        code=code.name,
                    ) from err
                self._direct_transport_failure(
                    code, read_budget >= self.BACKOFF_MIN_DEADLINE_S,
                    volume_id, direct, "window read")
        remaining = timeout - (time.monotonic() - t_start)
        if remaining <= 0:
            raise DeadlineExceeded(
                f"window of {volume_id!r} timed out before the proxy "
                "fallback could run")
        address = self._endpoints.current()
        t1 = time.monotonic()
        try:
            result = self._read_window(
                self._registry_channel(), volume_id, offset, length, remaining)
            self._record_window("proxy", result[0].size, time.monotonic() - t1)
            return result
        except grpc.RpcError as err:
            self._pool.maybe_evict(err, address)
            raise PublishError(
                f"{err.code().name}: {err.details()}",
                code=err.code().name,
            ) from err

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Release the feeder's background resources (the address-watch
        stream). Channels belong to the shared pool and stay pooled;
        a feeder that is never closed only leaves one daemon thread
        parked on a server stream."""
        watch, self._address_watch = self._address_watch, None
        if watch is not None:
            watch.stop()

    # -- unpublish ---------------------------------------------------------

    def unpublish(self, volume_id: str) -> None:
        """Idempotent unpublish (reference NodeUnpublishVolume,
        nodeserver.go:451-515)."""
        with self._keymutex.locked(volume_id):
            with self._lock:
                self._published.pop(volume_id, None)
            if self.controller is not None:
                self.controller.UnmapVolume(
                    pb.UnmapVolumeRequest(volume_id=volume_id), self._LocalContext()
                )
                return
            address = self._endpoints.current()
            try:
                ControllerStub(self._registry_channel()).UnmapVolume(
                    pb.UnmapVolumeRequest(volume_id=volume_id),
                    metadata=[(CONTROLLER_ID_META, self.controller_id)],
                    timeout=30.0,
                )
            except grpc.RpcError as err:
                self._pool.maybe_evict(err, address)
                raise PublishError(
                    f"{err.code().name}: {err.details()}",
                    code=err.code().name,
                ) from err
