"""The member leases of a sharded serve replica (the gRPC half of
``oim_tpu/serve/shard.py``): ``member_key``, ``_MemberPublisher`` and
``ShardMembers``.

Every member of an N-way replica holds a TTL lease under
``serve/<id>.member.<k>``; the rows publish no endpoint, so a router skips
them. ``ShardMembers.member_counts`` is the liveness poll that
``ServeEngine.set_member_watch`` folds into the replica's readiness: one
lapsed member flips the serve row not-ready. Kept apart from
``serve/shard.py``, which the engine imports on the card, where there is
no grpcio.
"""

from __future__ import annotations

import threading

import grpc

from oim_tpu_torch.common import channelpool
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.common.pathutil import REGISTRY_SERVE
from oim_tpu_torch.common.telemetry import RegistryRowPublisher
from oim_tpu_torch.common.tlsutil import TLSConfig
from oim_tpu_torch.serve.registration import serve_key
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub


# -- member leases ----------------------------------------------------------

def member_key(serve_id: str, rank: int) -> str:
    """``serve/<id>.member.<k>`` — one path component (dots, not
    slashes), so it rides the same ``serve`` prefix the router polls,
    while the missing ``endpoint`` keeps ``Replica.parse`` skipping it
    (member rows are liveness beacons, never routing targets)."""
    return serve_key(f"{serve_id}.member.{rank}")


class _MemberPublisher(RegistryRowPublisher):
    """One member's TTL lease row. Value is tiny and value-stable, so
    the default batched-Heartbeat renewal applies (unlike the serve row,
    which re-publishes its load snapshot every beat)."""

    THREAD_NAME = "oim-shard-member"

    def __init__(self, serve_id: str, rank: int, shard: int,
                 registry_address: str, **kwargs):
        super().__init__(member_key(serve_id, rank), registry_address,
                         **kwargs)
        self.rank = rank
        self.shard = shard

    def snapshot(self) -> dict:
        return {"member": self.rank, "shard": self.shard, "state": "ready"}


class ShardMembers:
    """The member-lease side of one sharded replica: N TTL-leased
    ``serve/<id>.member.<k>`` rows plus the liveness poll the engine's
    readiness folds in.

    In a real deployment each member PROCESS runs its own publisher for
    its own rank; in-process (bench, chaos sim) one ShardMembers drives
    all N rows, and :meth:`stop_member` is the SIGKILL lever — the
    row's heartbeats stop mid-lease, nothing deregisters, and the lapse
    is what flips the replica not-ready.
    """

    def __init__(self, serve_id: str, shard: int, registry_address: str,
                 *, interval: float = 10.0, tls: TLSConfig | None = None,
                 pool: channelpool.ChannelPool | None = None):
        self.serve_id = serve_id
        self.shard = shard
        self.registry_address = registry_address
        self.interval = interval
        self.tls = tls
        self._pool = pool if pool is not None else channelpool.shared()
        self._members: dict[int, _MemberPublisher] = {}
        self._lock = threading.Lock()
        self._last_counts = {"ready": shard, "stale": 0, "total": shard}

    def _new_publisher(self, rank: int) -> _MemberPublisher:
        return _MemberPublisher(
            self.serve_id, rank, self.shard, self.registry_address,
            interval=self.interval, tls=self.tls, pool=self._pool)

    def start(self) -> "ShardMembers":
        for rank in range(self.shard):
            m = self._new_publisher(rank)
            m.beat_once()  # deterministic first registration
            m.start()
            self._members[rank] = m
        return self

    def stop(self, deregister: bool = True) -> None:
        for m in self._members.values():
            m.stop(deregister=deregister)
        self._members.clear()

    # -- fault/heal levers (the chaos rung's handles) ----------------------

    def stop_member(self, rank: int) -> None:
        """SIGKILL semantics for member ``rank``: heartbeats stop
        mid-lease and the row is NOT deleted — it outlives the corpse
        until the TTL lapses, exactly like a killed replica's serve
        row."""
        self._members.pop(rank).stop(deregister=False)

    def restart_member(self, rank: int) -> None:
        """The member process rebooted (and re-staged its weight slice
        — a stage-cache hit): a fresh publisher re-takes the lease."""
        m = self._new_publisher(rank)
        m.beat_once()
        m.start()
        self._members[rank] = m

    # -- liveness poll ------------------------------------------------------

    def member_counts(self) -> dict:
        """``{"ready": live, "stale": lapsed, "total": shard}`` from one
        lease-filtered + one include_stale GetValues under this
        replica's member prefix. On a registry error the LAST known
        counts are returned (a flapping control-plane read must not
        flap the replica's readiness; the lease itself is the
        authority and the next poll re-reads it)."""
        prefix = f"{REGISTRY_SERVE}/{self.serve_id}.member."
        try:
            stub = RegistryStub(self._pool.get(
                self.registry_address.split(",")[0], self.tls,
                "component.registry"))
            live = [v for v in stub.GetValues(
                pb.GetValuesRequest(path=REGISTRY_SERVE),
                timeout=10.0).values if v.path.startswith(prefix)]
            everything = [v for v in stub.GetValues(
                pb.GetValuesRequest(path=REGISTRY_SERVE, include_stale=True),
                timeout=10.0).values if v.path.startswith(prefix)]
        except grpc.RpcError as err:
            from_context().warning(
                "member liveness poll failed", serve=self.serve_id,
                error=err.code().name)
            return dict(self._last_counts)
        counts = {"ready": len(live),
                  "stale": max(len(everything) - len(live), 0),
                  "total": self.shard}
        with self._lock:
            self._last_counts = counts
        return dict(counts)
