"""Registry endpoint lists: client-side failover across a replicated
pair or quorum.

Every ``--registry`` flag accepts a comma-separated endpoint list
(``primary:9421,standby:9421`` — or all 3+ quorum members). Clients
dial ``current()`` and, on the two failover statuses — ``UNAVAILABLE``
(endpoint dead/unreachable) and ``FAILED_PRECONDITION`` (endpoint is an
unpromoted standby / quorum follower refusing writes) — ``advance()``
to the next endpoint and retry through whatever retry machinery the
call site already has (the controller heartbeat loop's jittered
backoff, the feeder's heal loop, bootstrap's poll loop). Rotation is
intentionally dumb: with at most a handful of endpoints, a wrong
rotation costs one extra round trip and self-corrects on the next
failure. Quorum followers do better than rotation: their rejection
detail names the leader (``... leader=<addr>``), and ``apply_hint``
jumps the cursor straight there when the address is in the list.

The port's copy of ``oim_tpu/common/endpoints.py``; it imports nothing of
that package.
"""

from __future__ import annotations

import re
import threading

import grpc

# Statuses that mean "try the other registry endpoint": the endpoint is
# down, or it is a standby/follower that cannot serve this call.
FAILOVER_CODES = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.FAILED_PRECONDITION,
)

_LEADER_HINT = re.compile(r"\bleader=([^\s,]+)")


def leader_hint(err: grpc.RpcError) -> str:
    """The leader address a quorum follower's rejection named, or ""."""
    try:
        detail = err.details() or ""
    except Exception:  # noqa: BLE001 - non-RpcError shims in tests
        return ""
    m = _LEADER_HINT.search(detail)
    return m.group(1) if m else ""


def parse_endpoint_list(spec: str) -> list[str]:
    """Split a comma-separated endpoint spec; rejects an empty list."""
    endpoints = [e.strip() for e in spec.split(",") if e.strip()]
    if not endpoints:
        raise ValueError(f"empty registry endpoint list: {spec!r}")
    return endpoints


class RegistryEndpoints:
    """Thread-safe cursor over an ordered endpoint list.

    The order is preference order (primary first); ``advance`` rotates
    round-robin so repeated failures cycle the whole list rather than
    ping-ponging between two entries of a longer one.
    """

    def __init__(self, spec: str | list[str] | tuple[str, ...]):
        self._endpoints = (
            parse_endpoint_list(spec) if isinstance(spec, str) else list(spec)
        )
        if not self._endpoints:
            raise ValueError("empty registry endpoint list")
        self._index = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._endpoints)

    @property
    def multiple(self) -> bool:
        return len(self._endpoints) > 1

    def all(self) -> tuple[str, ...]:
        return tuple(self._endpoints)

    def current(self) -> str:
        with self._lock:
            return self._endpoints[self._index]

    def advance(self) -> str:
        """Rotate to the next endpoint (no-op for a single-entry list);
        returns the new current endpoint."""
        with self._lock:
            self._index = (self._index + 1) % len(self._endpoints)
            return self._endpoints[self._index]

    def prefer(self, endpoint: str) -> bool:
        """Jump the cursor to ``endpoint`` when it is in the list
        (quorum leader hint); returns whether it was."""
        with self._lock:
            try:
                self._index = self._endpoints.index(endpoint)
            except ValueError:
                return False
            return True

    def apply_hint(self, err: grpc.RpcError) -> bool:
        """Jump to the leader a FAILED_PRECONDITION rejection named
        (``... leader=<addr>``); returns whether the cursor moved. The
        caller still calls ``advance()`` when this returns False —
        hint-less rejections keep the dumb-rotation behavior."""
        hint = leader_hint(err)
        return bool(hint) and self.prefer(hint)
