"""Pooled gRPC channels: the client side of the direct data path.

The reference keeps control connections short-lived by design
(README.md:39-40) — and PR 1-4 inherited that as a fresh TLS dial per
RPC. That is the right stance for rare control traffic and exactly the
wrong one for the steady-state window feed, where a per-window dial pays
a TCP+TLS handshake and HTTP/2 setup on the hot loop (the same reason
tf.data service workers and Petastorm hold pooled readers open). This
module gives every client ONE persistent channel per (target,
credentials, pinned peer name):

* ``get()`` returns the pooled channel, dialing through ``tlsutil.dial``
  on first use (so the telemetry client interceptor still wraps every
  channel, and tests can spy on ``tlsutil.dial`` to count real dials);
* health-awareness is caller-driven: a caller that observes a
  transport-class failure (``UNAVAILABLE``, or ``DEADLINE_EXCEEDED`` —
  a black-holed established flow times out instead of refusing, and a
  pooled channel would otherwise ride that dead socket forever where
  the old dial-per-attempt code recovered on the next dial) calls
  ``maybe_evict`` — the channel is dropped and the next ``get()``
  re-dials. Other status codes mean the far end ANSWERED, so the
  channel stays pooled.
* ``oim_channel_pool_size`` gauges live channels across every pool in
  the process; ``stats()`` counts dials per target (the regression guard
  that N windows reuse one channel instead of dialing N times).

Eviction RETIRES the channel instead of closing it on the spot: closing
would cancel any RPC another thread has in flight on the shared pool
(turning a registry blip into a CANCELLED mid-stream for an innocent
window read) and opens a close-then-invoke ValueError race. Retired
channels are closed once they have aged past RETIRE_GRACE_S (reaped
lazily on later get/evict calls) or at ``close()`` — by then any RPC
that was riding them has long finished or failed on its own terms.

The port's copy of ``oim_tpu/common/channelpool.py``; it imports nothing of
that package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import grpc

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.tlsutil import TLSConfig

# (address, peer_name, TLSConfig | None, lane): TLSConfig is a frozen
# dataclass, so identical credentials hash to one pool slot; ``lane``
# stripes callers that hold MANY long-lived streams to one target across
# several connections (see ``get``).
PoolKey = tuple[str, str, "TLSConfig | None", int]


class ChannelPool:
    """Thread-safe pool of persistent channels keyed by (target, creds)."""

    # How long an evicted channel lingers before its sockets are closed:
    # long enough for any RPC that was in flight on it to finish or fail
    # on its own terms — it must EXCEED the longest read budget a caller
    # rides a pooled channel with (the feeder's fetch/fetch_window
    # default is 120 s; closing earlier would CANCEL a healthy
    # still-streaming whole-volume read just because another thread
    # evicted the same target) — while still bounded so a flapping
    # endpoint can't pile up file descriptors forever.
    RETIRE_GRACE_S = 300.0

    def __init__(self, dial: Callable[..., grpc.Channel] | None = None):
        # None = resolve tlsutil.dial at call time (monkeypatch-friendly).
        self._dial = dial
        self._channels: dict[PoolKey, grpc.Channel] = {}
        self._dials: dict[tuple[str, str], int] = {}
        self._retired: list[tuple[float, grpc.Channel]] = []
        self._lock = threading.Lock()
        # Per-key dial locks: dialing (TLS cert file reads + channel
        # setup) happens OUTSIDE self._lock so a re-dial to one slow
        # target never stalls another thread's cached-channel lookup,
        # while concurrent gets for the SAME key still dial exactly once.
        self._dialing: dict[PoolKey, threading.Lock] = {}

    def _reap_locked(self, now: float) -> list[grpc.Channel]:
        """Split off retired channels past the grace (call under _lock;
        close the returned channels OUTSIDE it)."""
        due = [c for t, c in self._retired if now - t >= self.RETIRE_GRACE_S]
        if due:
            self._retired = [
                (t, c) for t, c in self._retired
                if now - t < self.RETIRE_GRACE_S
            ]
        return due

    def get(self, address: str, tls: TLSConfig | None = None,
            peer_name: str = "", lane: int = 0) -> grpc.Channel:
        """The pooled channel for this target, dialing on first use.
        Callers never close the returned channel — they ``maybe_evict``
        on transport failures instead.

        ``lane`` selects among SEVERAL pooled connections to one target:
        one gRPC channel is one HTTP/2 connection, whose single
        connection-level flow-control window and in-order frame stream
        serialize the many concurrent long-lived streams a fan-in caller
        (the request router) lays on it — measured on the serving path,
        enough to halve 2-replica throughput. Callers with that shape
        stripe streams round-robin over a small lane set; unary/occasional
        callers keep the default single lane. Eviction drops every lane
        to the address at once (transport failures are per-endpoint, not
        per-connection)."""
        key = (address, peer_name, tls, lane)
        now = time.monotonic()
        with self._lock:
            due = self._reap_locked(now)
            channel = self._channels.get(key)
            keylock = (None if channel is not None
                       else self._dialing.setdefault(key, threading.Lock()))
        self._close_async(due)
        if channel is not None:
            return channel
        with keylock:
            with self._lock:
                channel = self._channels.get(key)
            if channel is not None:  # another thread won the dial race
                return channel
            dial = self._dial
            if dial is None:
                from oim_tpu_torch.common import tlsutil

                dial = tlsutil.dial
            channel = dial(address, tls, peer_name)
            with self._lock:
                self._channels[key] = channel
                stat_key = (address, peer_name)
                self._dials[stat_key] = self._dials.get(stat_key, 0) + 1
                M.CHANNEL_POOL_SIZE.inc(1)
        return channel

    def evict(self, address: str) -> int:
        """Drop every pooled channel to ``address`` (all peer names /
        credentials) so the next ``get`` re-dials; returns how many were
        evicted. The dropped channels are RETIRED, not closed — an RPC
        another thread has in flight on one finishes (or fails) on its
        own terms instead of being cancelled under it."""
        now = time.monotonic()
        with self._lock:
            keys = [k for k in self._channels if k[0] == address]
            evicted = [self._channels.pop(k) for k in keys]
            self._retired.extend((now, c) for c in evicted)
            due = self._reap_locked(now)
            M.CHANNEL_POOL_SIZE.inc(-len(evicted))
        self._close_async(due)
        return len(evicted)

    @staticmethod
    def _close_async(channels) -> None:
        """Close reaped channels off-thread: closing a channel whose
        event machinery is wedged (lost termination events — the reason
        it was evicted) can block inside the core, and reap runs on
        whatever caller happens by next, often a heal path that must
        not pay that."""
        if not channels:
            return
        threading.Thread(
            target=lambda: [c.close() for c in channels],
            daemon=True, name="oim-channel-reaper").start()

    # Transport-class statuses: the RPC never got an answer. UNAVAILABLE
    # is the endpoint refusing/dead; DEADLINE_EXCEEDED is the black-holed
    # flow (VIP re-pointed, peer silently gone — packets drop, no RST),
    # where re-using the established socket can NEVER recover but a
    # fresh dial does. An eviction costs one re-dial, so a merely-slow
    # server answering late is a cheap false positive.
    TRANSPORT_CODES = (
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
    )

    def maybe_evict(self, err: Exception, address: str) -> bool:
        """Evict ``address`` when ``err`` is a transport-level failure
        (see TRANSPORT_CODES). Any other gRPC status means the far end
        answered — the channel is healthy and stays pooled."""
        if (isinstance(err, grpc.RpcError)
                and err.code() in self.TRANSPORT_CODES):
            return self.evict(address) > 0
        return False

    def targets(self) -> list[str]:
        with self._lock:
            return sorted({k[0] for k in self._channels})

    def stats(self) -> dict[tuple[str, str], int]:
        """(address, peer_name) -> lifetime dial count (evictions and
        re-dials increment; steady-state traffic must not)."""
        with self._lock:
            return dict(self._dials)

    def __len__(self) -> int:
        with self._lock:
            return len(self._channels)

    def close(self) -> None:
        """Close every pooled and retired channel (process shutdown /
        test teardown)."""
        with self._lock:
            channels = list(self._channels.values())
            channels += [c for _, c in self._retired]
            M.CHANNEL_POOL_SIZE.inc(-len(self._channels))
            self._channels.clear()
            self._retired.clear()
        for channel in channels:
            channel.close()


_shared: ChannelPool | None = None
_shared_lock = threading.Lock()


def shared() -> ChannelPool:
    """The process-wide default pool: a feeder and a controller heartbeat
    loop living in one process share their registry channel."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = ChannelPool()
        return _shared
