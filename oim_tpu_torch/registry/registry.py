"""Registry service: KV store with CommonName authorization + transparent proxy.

Reference: pkg/oim-registry/registry.go. Authorization (registry.go:100-109):
``user.admin`` may set any key; ``controller.<id>`` may set only its own
``<id>/address`` and ``<id>/mesh`` keys. (The reference restricts controllers
to ``<id>/address`` and has the admin seed ``<id>/pci``; here ``<id>/mesh`` is
self-reported under the same trust already extended to the address key — a
controller that can redirect its own traffic can equally mis-place itself, so
this widens no trust boundary. Operators can still override it as admin.)

The transparent proxy (registry.go:149-210): every gRPC method outside
``oim.v1.Registry`` is forwarded to the controller named in the
``controllerid`` request metadata. The caller's CN must be ``host.<id>`` for
that exact controller id; the registry looks up ``<id>/address`` in its DB and
forwards over a POOLED channel with the far end's identity pinned to
``controller.<id>`` (ssl_target_name_override). The reference dialed per-call
(control connections short-lived by design, README.md:39-40); with the pool a
proxied call rides one persistent channel per (address, identity) and a
transport failure evicts it, so a restarted controller still heals on the
caller's next attempt.
"""

from __future__ import annotations

import threading
from typing import Callable

import grpc

from oim_tpu_torch.common import faultinject, metrics as M, tracing
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.rpctelemetry import method_label
from oim_tpu_torch.common.pathutil import (
    REGISTRY_ADDRESS,
    REGISTRY_ALERT,
    REGISTRY_FLEET,
    REGISTRY_MESH,
    REGISTRY_SERVE,
    REGISTRY_TELEMETRY,
    path_has_prefix,
    split_registry_path,
)
from oim_tpu_torch.common.server import NonBlockingGRPCServer
from oim_tpu_torch.common.interceptors import LogServerInterceptor
from oim_tpu_torch.common.channelpool import ChannelPool
from oim_tpu_torch.common.tlsutil import TLSConfig, peer_common_name
from oim_tpu_torch.registry.db import MemRegistryDB, RegistryDB, get_registry_entries
from oim_tpu_torch.registry.leases import LeaseTable
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import (
    REGISTRY_SERVICE,
    RegistryServicer,
    add_registry_to_server,
)

CONTROLLER_ID_META = "controllerid"


class RegistryService(RegistryServicer):
    def __init__(
        self,
        db: RegistryDB | None = None,
        tls: TLSConfig | None = None,
        leases: LeaseTable | None = None,
        boot_grace_seconds: float = 0.0,
    ):
        self.db: RegistryDB = db if db is not None else MemRegistryDB()
        self.tls = tls
        # The liveness overlay (registry/leases.py): entries written with
        # lease_seconds stay visible only while heartbeats renew them.
        self.leases = leases if leases is not None else LeaseTable()
        # Set by ReplicationManager when this registry is half of a
        # primary/standby pair (registry/replication.py) or by
        # QuorumManager for a raft-style 3+ member (registry/quorum.py):
        # standbys/followers refuse writes, mutations feed the journal,
        # and the virtual "registry/..." status keys appear in GetValues.
        self.replication = None
        # The Watch hub: every COMMITTED mutation (apply_kv below — the
        # legacy write path, a quorum commit, a standby's replication
        # apply) fans out as a prefix-scoped delta to attached Watch
        # streams (registry/watch.py).
        from oim_tpu_torch.registry.watch import WatchHub

        self.watch = WatchHub(self)
        # Serializes a write's state mutation WITH its journal append:
        # without it, two racing writes to one key could journal in the
        # opposite order they were applied and diverge the standby.
        self._write_lock = threading.Lock()
        if boot_grace_seconds > 0:
            # A pre-populated DB (FileRegistryDB journal replay) carries no
            # lease state — monotonic deadlines cannot survive a restart.
            # Grace-lease every replayed controller key: live controllers
            # renew (or re-register) within one heartbeat; dead ones expire
            # after the grace instead of being resurrected as permanent —
            # the exact stale-registration wedge the lease plane removes.
            # Admin keys under other layouts stay permanent.
            for path in get_registry_entries(self.db, ""):
                parts = path.split("/")
                if len(parts) == 2 and parts[1] in (REGISTRY_ADDRESS,
                                                    REGISTRY_MESH):
                    self.leases.grant(path, boot_grace_seconds)

    # -- authorization ----------------------------------------------------

    def _peer(self, context: grpc.ServicerContext) -> str:
        """Verified peer CN; empty for insecure servers (test-only)."""
        if self.tls is None:
            return "user.admin"  # insecure mode trusts everyone (tests only)
        cn = peer_common_name(context)
        if not cn:
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "no verified peer identity")
        return cn

    @staticmethod
    def _may_set(peer: str, path_parts: list[str]) -> bool:
        """Reference registry.go:100-109, extended with the mesh key, the
        serving tier's ``serve/<id>`` load rows, and the observability
        plane's ``telemetry/<id>`` rows."""
        if peer == "user.admin":
            return True
        if len(path_parts) == 2 and path_parts[0] == REGISTRY_TELEMETRY:
            # The serve/ reservation pattern, extended: ANY authenticated
            # identity may publish a telemetry row, but only under its
            # OWN id (or a dot-suffixed variant, for several processes on
            # one host: telemetry/host-0.feeder) — no daemon can overwrite
            # another's row and redirect `oimctl --top` scrapes.
            owner = next(
                (peer[len(prefix):]
                 for prefix in ("controller.", "host.", "component.")
                 if peer.startswith(prefix)),
                "")
            row_id = path_parts[1]
            return bool(owner) and (
                row_id == owner or row_id.startswith(owner + "."))
        if len(path_parts) == 2 and path_parts[0] == REGISTRY_ALERT:
            # The SLO plane's alert/<name> rows: only a monitor identity
            # (component.monitor, or a dot-suffixed variant for an HA
            # pair) may publish them — an alert row drives the future
            # autoscaler, so no replica/controller identity may forge
            # one. Alert names are SLO names, not the writer's id, so
            # the telemetry own-row rule cannot apply here.
            return peer == "component.monitor" \
                or peer.startswith("component.monitor.")
        if len(path_parts) == 2 and path_parts[0] == REGISTRY_FLEET:
            # The actuator's fleet/<name> desired-state rows: only an
            # autoscaler identity (component.autoscaler, or a
            # dot-suffixed variant for an HA standby) may publish them.
            # The row IS the leader lease — a forged fleet row would
            # both lie to `oimctl --top` and fence out the real leader.
            return peer == "component.autoscaler" \
                or peer.startswith("component.autoscaler.")
        if peer.startswith("controller."):
            controller_id = peer[len("controller."):]
            return (
                len(path_parts) == 2
                and path_parts[0] == controller_id
                # "serve", "telemetry", "alert" and "fleet" are reserved
                # namespaces: a controller named serve could otherwise
                # write serve/address — and its Heartbeat would
                # prefix-renew EVERY replica's lease (same hole for
                # telemetry, alert and fleet rows).
                and controller_id not in (REGISTRY_SERVE,
                                          REGISTRY_TELEMETRY,
                                          REGISTRY_ALERT,
                                          REGISTRY_FLEET)
                and path_parts[1] in (REGISTRY_ADDRESS, REGISTRY_MESH)
            )
        if peer.startswith("host.") and len(path_parts) == 2 \
                and path_parts[0] == REGISTRY_SERVE:
            # A serve replica registers its serve/<id> row under its host
            # identity (remote mode dials as host.<controller-id>). The
            # serve id must be the host's own controller id — or a
            # dot-suffixed variant of it, for several replicas on one
            # host — so no host can overwrite another replica's row and
            # steal its traffic.
            host_id = peer[len("host."):]
            serve_id = path_parts[1]
            return serve_id == host_id or serve_id.startswith(host_id + ".")
        return False

    # -- committed-state mutation (every apply path funnels here) ----------

    def apply_kv(self, path: str, value: str, lease_seconds: float) -> None:
        """Apply one committed KV mutation: DB, lease overlay, Watch
        fan-out. Callers serialize (the write lock, the replication
        apply thread, or the quorum commit loop)."""
        self.db.set(path, value)
        if value == "":
            # Deleted entries carry no lease; a later permanent
            # re-write must not inherit a stale deadline.
            self.leases.drop(path)
        else:
            # lease_seconds > 0 grants/refreshes; 0 (proto default)
            # writes a permanent entry — the pre-lease behavior and
            # the admin override path (oimctl --set pins a key past
            # lease filtering).
            self.leases.grant(path, lease_seconds)
        self.watch.publish_kv(path, value, lease_seconds)

    def apply_renew(self, prefix: str, ttl: float) -> int:
        """Apply one committed lease renewal. An exact leased row (the
        batched-Heartbeat shape) renews O(1); anything else falls back
        to the component-wise prefix scan (the controller-id shape —
        the bare id itself is never a leased path). No Watch delta —
        the value did not change; a renewal that resurrects a
        swept-expired row is re-announced by the hub's sweeper."""
        renewed = self.leases.renew_path(prefix, ttl)
        if renewed:
            return renewed
        return self.leases.renew(prefix, ttl)

    # -- service methods --------------------------------------------------

    def _reject_if_standby(self, context) -> None:
        repl = self.replication
        if repl is not None and not repl.is_primary:
            hint = repl.leader_hint()
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"standby (epoch {repl.epoch}): writes go to the primary"
                + (f" leader={hint}" if hint else ""),
            )

    def _propose(self, context, propose, *args):
        """Run a quorum proposal, mapping its failures to statuses: a
        leader that lost the majority answers UNAVAILABLE (the write was
        never acknowledged anywhere), a step-down mid-flight answers
        FAILED_PRECONDITION like any other non-leader."""
        from oim_tpu_torch.registry import quorum as Q

        try:
            return propose(*args)
        except Q.NotLeader as err:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"not the quorum leader: writes go to the leader"
                + (f" leader={err.hint}" if err.hint else ""),
            )
        except Q.QuorumUnavailable as err:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(err))

    def SetValue(self, request, context):
        from oim_tpu_torch.registry import replication as R

        peer = self._peer(context)
        try:
            parts = split_registry_path(request.value.path)
        except ValueError as err:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
        if parts[0] == R.RESERVED_REGISTRY_ID:
            # The replication control/status namespace — reserved even on
            # an unreplicated registry, so a controller id "registry" can
            # never register standalone and then break (plus collide with
            # the virtual status keys) once --peer is enabled. The one
            # write it accepts is the admin promote command — notably
            # accepted BY A STANDBY (that is its whole point:
            # oimctl --promote).
            if peer != "user.admin":
                context.abort(
                    grpc.StatusCode.PERMISSION_DENIED,
                    f"{peer!r} may not write the reserved "
                    f"{R.RESERVED_REGISTRY_ID}/ namespace",
                )
            if request.value.path == R.PROMOTE_KEY:
                if self.replication is None:
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION,
                        "replication not configured on this registry "
                        "(--peer)",
                    )
                # Empty value is SetValue's delete idiom — an admin
                # cleaning up keys must not trigger a failover.
                if request.value.value:
                    self.replication.promote(reason=f"SetValue by {peer}")
                return pb.SetValueReply()
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"{R.RESERVED_REGISTRY_ID}/ status keys are read-only",
            )
        self._reject_if_standby(context)
        if not self._may_set(peer, parts):
            context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"{peer!r} may not set {request.value.path!r}",
            )
        repl = self.replication
        if repl is not None and repl.quorum:
            # Quorum mode: the write is a journal proposal; it applies
            # (and becomes GetValues/Watch-visible) only once a majority
            # of members hold the record — the proposal blocks until
            # that commit or fails without ever acknowledging.
            self._propose(
                context, repl.propose_kv, request.value.path,
                request.value.value, request.value.lease_seconds)
            return pb.SetValueReply()
        with self._write_lock:
            self.apply_kv(request.value.path, request.value.value,
                          request.value.lease_seconds)
            if repl is not None:
                repl.record_kv(
                    request.value.path, request.value.value,
                    request.value.lease_seconds)
        return pb.SetValueReply()

    def GetValues(self, request, context):
        # Reads need any authenticated identity; prefix-match semantics
        # (registry.go:129-144). Lease-expired entries are invisible unless
        # the caller opts into stale reads (oimctl debugging).
        self._peer(context)
        M.REGISTRY_GETVALUES.inc()
        if request.path:
            try:
                split_registry_path(request.path)
            except ValueError as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
        entries = get_registry_entries(self.db, request.path)
        values = [
            pb.Value(path=k, value=v)
            for k, v in sorted(entries.items())
            if request.include_stale or self.leases.alive(k)
        ]
        if self.replication is not None:
            # Virtual replication status keys (role/epoch/lag): never
            # stored or leased, served by primary and standby alike so
            # oimctl --health works against either endpoint. Skipped
            # entirely unless the prefix can reach them — status_entries()
            # costs locks and a journal-size stat, and the hot read paths
            # (bootstrap polling, feeder re-resolution) never ask for it.
            parts = request.path.split("/") if request.path else []
            from oim_tpu_torch.registry import replication as R

            if not parts or parts[0] == R.RESERVED_REGISTRY_ID:
                values.extend(
                    pb.Value(path=k, value=v)
                    for k, v in sorted(
                        self.replication.status_entries().items())
                    if path_has_prefix(k, parts)
                )
        return pb.GetValuesReply(values=values)

    def Heartbeat(self, request, context):
        """Renew the leases on every ``<controller_id>/...`` key (the
        etcd-KeepAlive analog), plus any explicitly listed ``keys`` —
        the batch path that lets a daemon renew ALL its leased rows
        (serve/<id>, telemetry/<id>, controller keys) in one round-trip.
        Authorization mirrors SetValue: a caller may renew only what it
        could write."""
        from oim_tpu_torch.registry import replication as R

        peer = self._peer(context)
        if not request.controller_id and not request.keys:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty controller_id")
        if request.controller_id:
            try:
                parts = split_registry_path(request.controller_id)
            except ValueError as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
            if len(parts) != 1:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"controller_id {request.controller_id!r} is a path, "
                    f"not an id",
                )
            if request.controller_id in (REGISTRY_SERVE, REGISTRY_TELEMETRY,
                                         REGISTRY_ALERT, REGISTRY_FLEET):
                # Renewal is prefix-scoped: a "serve"/"telemetry"/"alert"
                # /"fleet" heartbeat would renew EVERY row's lease in that
                # namespace at once. Those rows renew individually via
                # the batch `keys` list (or by re-publishing).
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"{request.controller_id!r} is a reserved namespace, "
                    "not a controller id",
                )
            if not (peer == "user.admin"
                    or peer == f"controller.{request.controller_id}"):
                context.abort(
                    grpc.StatusCode.PERMISSION_DENIED,
                    f"{peer!r} may not heartbeat "
                    f"{request.controller_id!r}",
                )
        keys = list(request.keys)
        for key in keys:
            try:
                key_parts = split_registry_path(key)
            except ValueError as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
            if key_parts[0] == R.RESERVED_REGISTRY_ID:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"{R.RESERVED_REGISTRY_ID}/ keys are never leased",
                )
            if not self._may_set(peer, key_parts):
                context.abort(
                    grpc.StatusCode.PERMISSION_DENIED,
                    f"{peer!r} may not renew {key!r}",
                )
        self._reject_if_standby(context)
        prefixes = ([request.controller_id] if request.controller_id
                    else []) + keys
        repl = self.replication
        if repl is not None and repl.quorum:
            # Quorum mode: the renewals are journal proposals; the
            # known/keys_known verdicts are computed from the leader's
            # (committed) lease table up front — renewing never creates
            # a lease, so pre-propose existence equals the post-commit
            # verdict. Exact rows check O(1); only the controller-id
            # prefix pays a scan.
            counts = {p: (1 if self.leases.has_lease(p)
                          else self.leases.count(p))
                      for p in prefixes}
            self._propose(
                context, repl.propose_renews,
                [p for p in prefixes if counts[p] > 0],
                request.lease_seconds)
        else:
            counts = {}
            with self._write_lock:
                for prefix in prefixes:
                    counts[prefix] = self.apply_renew(
                        prefix, request.lease_seconds)
                    if counts[prefix] > 0 and repl is not None:
                        # Renewals ship as logical records: the standby
                        # re-bases the deadline on its own monotonic
                        # clock.
                        repl.record_renew(prefix, request.lease_seconds)
        # known == False tells the controller to re-register in full. Two
        # causes: the registry has no address for it (restart, lost soft
        # state), or the address exists WITHOUT a lease to renew (journal
        # replay after a --db-file restart) — re-registering re-grants the
        # lease from the controller, the source of truth for its TTL.
        known = bool(
            request.controller_id
            and counts[request.controller_id] > 0
            and self.db.get(f"{request.controller_id}/{REGISTRY_ADDRESS}"))
        # keys_known parallels keys: the row exists AND its lease
        # renewed. A pre-batch registry never sets this field at all —
        # the caller's degrade-to-republish signal.
        keys_known = [counts[k] > 0 and bool(self.db.get(k)) for k in keys]
        return pb.HeartbeatReply(known=known, keys_known=keys_known)

    def Replicate(self, request, context):
        """Stream the journal to a standby registry (or answer a probe).
        Authorization: the peer registry dials with its own
        ``component.registry`` identity; ``user.admin`` may also probe
        (debugging). The record semantics live in
        registry/replication.py."""
        peer = self._peer(context)
        if peer not in ("component.registry", "user.admin"):
            context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"{peer!r} may not replicate the registry",
            )
        if self.replication is None:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "replication not configured on this registry (--peer)",
            )
        return self.replication.serve(request, context)

    def Watch(self, request, context):
        """Stream prefix-scoped KV deltas (registry/watch.py). Reads
        need any authenticated identity, like GetValues; served by
        leader/primary and followers/standbys alike from committed
        state."""
        self._peer(context)
        if request.path:
            try:
                split_registry_path(request.path)
            except ValueError as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
        return self.watch.serve(request, context)

    def _quorum_or_abort(self, context):
        repl = self.replication
        if repl is None or not repl.quorum:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "not a quorum registry member (--quorum)",
            )
        return repl

    def Vote(self, request, context):
        """Quorum leader election (registry/quorum.py). Authorization as
        Replicate: the peer registries or an admin."""
        peer = self._peer(context)
        if peer not in ("component.registry", "user.admin"):
            context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"{peer!r} may not vote in registry elections",
            )
        return self._quorum_or_abort(context).on_vote(request, context)

    def Ack(self, request, context):
        """Quorum follower -> leader replication acknowledgement
        (registry/quorum.py). Authorization as Replicate."""
        peer = self._peer(context)
        if peer not in ("component.registry", "user.admin"):
            context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"{peer!r} may not ack registry replication",
            )
        return self._quorum_or_abort(context).on_ack(request, context)


_IDENTITY = lambda b: b  # noqa: E731 - bytes pass-through serdes for proxying


class TransparentProxy(grpc.GenericRpcHandler):
    """Forward unknown methods to the controller in `controllerid` metadata.

    The Python analog of grpc.UnknownServiceHandler(proxy.TransparentHandler)
    + proxy.Codec() (reference registry.go:248-261): a generic handler with
    identity (bytes) serializers so payloads stream through untouched.
    """

    def __init__(
        self,
        service: RegistryService,
        dial: Callable[[str, str], grpc.Channel] | None = None,
    ):
        self._service = service
        # Controller channels are POOLED: one persistent channel per
        # (address, pinned identity) instead of a dial/close per proxied
        # call (the last per-call dialer on the serving path). Transport
        # failures evict, so a restarted controller heals on the caller's
        # next attempt exactly as per-call dialing did.
        if dial is not None:
            # dial(address, expected_peer_name) -> channel (test override).
            self._pool = ChannelPool(
                dial=lambda address, tls, peer_name: dial(address, peer_name))
        else:
            self._pool = ChannelPool()

    def _channel(self, address: str, peer_name: str) -> grpc.Channel:
        return self._pool.get(address, self._service.tls, peer_name)

    def close(self) -> None:
        """Release the pooled controller channels (registry shutdown)."""
        self._pool.close()

    # The one proxied method a host may call on a FOREIGN controller.
    PRESTAGE_METHOD = "/oim.v1.Controller/PrestageVolume"

    def _may_prestage(self, peer: str | None, method: str) -> bool:
        """The cross-controller prestage exemption (ROADMAP item 5 note):
        the strict ``host.<id>`` -> ``<id>`` rule blocks warm-standby and
        serve weight fan-out under mTLS, because both prestage PEER
        controllers. PrestageVolume is a content-addressed cache warm —
        it maps nothing, mutates no volume, and a bogus warm just ages
        out of the LRU — so it is exempted for any LIVE mesh member: a
        ``host.<x>`` whose OWN controller is registered with an unexpired
        lease (an unregistered/expired identity stays locked out, and
        every other method keeps the strict rule)."""
        if method != self.PRESTAGE_METHOD:
            return False
        if not peer or not peer.startswith("host."):
            return False
        own_key = f"{peer[len('host.'):]}/{REGISTRY_ADDRESS}"
        return bool(self._service.db.get(own_key)) \
            and self._service.leases.expired_for(own_key) is None

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method.startswith(f"/{REGISTRY_SERVICE}/"):
            # Never proxy registry methods (reference registry.go:158-161);
            # unknown Registry methods fail as unimplemented.
            return None
        # Keep the original (multi-valued) metadata tuple; only routing reads
        # need a dict view.
        metadata = tuple(handler_call_details.invocation_metadata or ())

        def handler(request_iterator, context):
            return self._forward(method, metadata, request_iterator, context)

        return grpc.stream_stream_rpc_method_handler(
            handler, request_deserializer=_IDENTITY, response_serializer=_IDENTITY
        )

    def _forward(self, method, metadata, request_iterator, context):
        log = from_context()
        controller_id = next(
            (v for k, v in metadata if k == CONTROLLER_ID_META), ""
        )
        if not controller_id:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"missing {CONTROLLER_ID_META} metadata",
            )
        # Authorization: only the host assigned to this controller may talk to
        # it (reference registry.go:176-184) — except the one narrowly-scoped
        # cross-controller exemption, PrestageVolume (see _may_prestage).
        if self._service.tls is not None:
            peer = peer_common_name(context)
            if peer != f"host.{controller_id}" and not self._may_prestage(
                    peer, method):
                context.abort(
                    grpc.StatusCode.PERMISSION_DENIED,
                    f"{peer!r} may not access controller {controller_id!r}",
                )
        address_key = f"{controller_id}/{REGISTRY_ADDRESS}"
        address = self._service.db.get(address_key)
        if not address:
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"no address registered for controller {controller_id!r}",
            )
        overdue = self._service.leases.expired_for(address_key)
        if overdue is not None:
            # Fast-fail instead of dialing a dead address and hanging the
            # caller until its deadline (health plane; cf. etcd lease TTLs).
            M.PROXY_FASTFAILS.inc()
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"controller lease expired: {controller_id!r} last renewed "
                f"{overdue:.1f}s past its lease",
            )
        try:
            faultinject.fire("proxy.dial", controller_id=controller_id,
                             address=address)
        except faultinject.InjectedFault:
            # An armed dial fault presents exactly as a dead controller.
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"injected dial failure for controller {controller_id!r}",
            )
        log.debug("proxying", method=method, controller=controller_id, address=address)
        # Pooled channel with pinned far-end identity (registry.go:191-210
        # dialed per call; see __init__).
        # The hop is traced explicitly — extract the caller's context from
        # the raw metadata and re-inject the hop span's own id — because
        # the generic handler's generator body cannot rely on the server
        # interceptor's ambient contextvar: one trace_id then follows
        # feeder -> proxy -> controller (doc/architecture.md Observability).
        parent = tracing.extract(metadata)
        with tracing.start_span(
                f"proxy:{method_label(method)}", parent=parent,
                controller=controller_id) as span:
            forwarded = tracing.inject(
                [(k, v) for k, v in metadata if k != CONTROLLER_ID_META],
                span.context)
            channel = self._channel(address, f"controller.{controller_id}")
            try:
                call = channel.stream_stream(
                    method, request_serializer=_IDENTITY,
                    response_deserializer=_IDENTITY,
                )(
                    request_iterator,
                    timeout=context.time_remaining(),
                    metadata=forwarded,
                )
                for response in call:
                    yield response
            except grpc.RpcError as err:
                # Transport failure: drop the pooled channel so the next
                # proxied call re-dials (a restarted controller heals on
                # the caller's retry, same as per-call dialing).
                self._pool.maybe_evict(err, address)
                span.attrs["code"] = err.code().name
                context.abort(err.code(), err.details())


def registry_server(
    endpoint: str,
    service: RegistryService,
    dial: Callable[[str, str], grpc.Channel] | None = None,
) -> NonBlockingGRPCServer:
    """Build the registry's server with the proxy attached
    (reference registry.go:248-261)."""
    server = NonBlockingGRPCServer(
        endpoint, tls=service.tls, interceptors=(LogServerInterceptor(),)
    )

    proxy = TransparentProxy(service, dial)

    def register(grpc_server: grpc.Server) -> None:
        add_registry_to_server(service, grpc_server)
        grpc_server.add_generic_rpc_handlers((proxy,))

    # The proxy's pooled controller channels live exactly as long as the
    # registry serves (a test process running several registries must not
    # accumulate channels across their lifetimes); same for the Watch
    # hub's sweeper thread and attached streams.
    server.add_cleanup(proxy.close)
    hub = getattr(service, "watch", None)
    if hub is not None:  # mixed-version test doubles predate the hub
        server.add_cleanup(hub.stop)
    server.start(register)
    return server
