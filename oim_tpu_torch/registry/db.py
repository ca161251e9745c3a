"""Registry database interface + in-memory implementation
(reference pkg/oim-registry/memdb.go, registry.go:31-51).

The DB is deliberately soft-state: controllers re-register every
registry_delay, so losing it merely delays topology convergence
(README.md:138-143). A durable backend can implement the same interface.
"""

from __future__ import annotations

import threading
from typing import Callable, Protocol


class RegistryDB(Protocol):
    def get(self, path: str) -> str: ...

    def set(self, path: str, value: str) -> None:
        """Empty value deletes the key."""
        ...

    def foreach(self, fn: Callable[[str, str], bool]) -> None:
        """Call fn(path, value) for each entry until it returns False."""
        ...


class MemRegistryDB:
    """Mutex-guarded dict (reference memdb.go:15-52)."""

    def __init__(self) -> None:
        self._data: dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, path: str) -> str:
        with self._lock:
            return self._data.get(path, "")

    def set(self, path: str, value: str) -> None:
        with self._lock:
            if value == "":
                self._data.pop(path, None)
            else:
                self._data[path] = value

    def foreach(self, fn: Callable[[str, str], bool]) -> None:
        with self._lock:
            items = list(self._data.items())
        for path, value in items:
            if not fn(path, value):
                return


class FileRegistryDB(MemRegistryDB):
    """MemRegistryDB + an append-only journal, replayed at construction.

    The reference aspires to an etcd backend and never builds one
    (README.md:36-40 vs the single memdb.go); this is the minimal durable
    step that keeps the soft-state contract: the journal only shortens
    topology convergence after a registry restart (entries reappear
    immediately instead of after one registry_delay) and preserves
    admin-written keys that no controller re-registers. Records are JSON
    lines ({"k": path, "v": value}; empty/absent value = delete), so any
    byte sequence MemRegistryDB accepts — spaces, newlines, unicode —
    round-trips exactly, and a torn final line from a crash mid-append
    fails the JSON parse and is skipped instead of replaying as a phantom
    key. fsync per mutation (registry writes are rare control-plane
    events — README.md:39 "short-lived, infrequent connections" — so
    durability costs nothing that matters). The journal compacts at load.
    """

    def __init__(self, path: str) -> None:
        import json
        import os

        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    if not line.endswith("\n"):
                        break  # torn tail from a crash mid-append
                    try:
                        rec = json.loads(line)
                        key = rec["k"]
                    except (ValueError, KeyError, TypeError):
                        continue  # unparseable record: skip, don't invent
                    value = rec.get("v", "")
                    if value == "":
                        self._data.pop(key, None)
                    else:
                        self._data[key] = value
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._json = json
        self._os = os
        # Compact: rewrite the current state, then append from there.
        self._journal = None
        self._rewrite()

    def set(self, path: str, value: str) -> None:
        import os

        with self._lock:
            # No-op writes skip the journal: controllers re-register the
            # SAME address every registry_delay, which would otherwise grow
            # the journal (and fsync) without bound between restarts.
            if value == self._data.get(path, ""):
                return
            if value == "":
                self._data.pop(path, None)
            else:
                self._data[path] = value
            self._journal.write(
                self._json.dumps({"k": path, "v": value}) + "\n")
            self._journal.flush()
            os.fsync(self._journal.fileno())

    def _rewrite(self) -> None:
        """Rewrite the journal as one record per live key and reopen it for
        appends. Caller holds no lock (construction) or ``self._lock``
        (compact). fsyncs the file AND its directory: ``os.replace`` alone
        is not durable — a crash right after the rename can lose the new
        directory entry and resurrect the uncompacted journal."""
        os, json = self._os, self._json
        if self._journal is not None:
            self._journal.close()
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for key, value in self._data.items():
                f.write(json.dumps({"k": key, "v": value}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        dirfd = os.open(os.path.dirname(os.path.abspath(self.path)), os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._journal = open(self.path, "a", encoding="utf-8")  # noqa

    def compact(self) -> None:
        """Collapse the journal to current state. Safe while writers are
        live (``set`` serializes on the same lock); a replication standby
        calls this after applying a snapshot so the delete-and-rewrite
        churn does not accumulate."""
        with self._lock:
            self._rewrite()

    def journal_bytes(self) -> int:
        """Current on-disk journal size (health/status reporting)."""
        try:
            return self._os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        """Idempotent: the registry shutdown path and atexit may both get
        here; a second close must not raise on the closed handle."""
        with self._lock:
            if self._journal is not None and not self._journal.closed:
                self._journal.close()


def get_registry_entries(db: RegistryDB, prefix: str) -> dict[str, str]:
    """All entries at or under ``prefix`` (reference GetRegistryEntries,
    registry.go:44-51); empty prefix returns everything."""
    from oim_tpu_torch.common.pathutil import path_has_prefix

    parts = prefix.split("/") if prefix else []
    out: dict[str, str] = {}

    def visit(path: str, value: str) -> bool:
        if path_has_prefix(path, parts):
            out[path] = value
        return True

    db.foreach(visit)
    return out
