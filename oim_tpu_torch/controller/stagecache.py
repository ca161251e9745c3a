"""Content-addressed stage cache (``oim_tpu/controller/stagecache.py``):
staged volumes keyed by what they ARE, not what they're called.

A staged volume is a pure function of (source content, requested spec,
placement domain). The cache keys on exactly that: params kind, extent
locators with their fingerprints (a file's mtime_ns and size, an object's
size, ETag and Last-Modified), the encoded ArraySpec and a
backend-provided placement signature. An identical re-publish returns
the resident tensor in O(1) instead of re-reading the source.

Entries are pinned while a mapped volume references them and become
eviction candidates (LRU) once idle; inserting past ``capacity_bytes``
evicts idle entries first. A source file that changes on disk changes its
fingerprint, so the stale entry stops matching and is invalidated on the
next insert that shares its locators.

A tensor has no ``delete()``: an evicted entry frees its device memory by
dropping the cache's reference (``entry.array = None``); the memory goes
back to the allocator once no volume or caller holds the tensor either.

Every change sets ``oim_stage_cache_bytes`` and ``oim_stage_cache_entries``;
an eviction counts in ``oim_stage_cache_evictions_total`` and lands a
``stage_cache_eviction`` flight-recorder event; ``count`` feeds
``oim_stage_cache_{hits,misses}_total``. ``stats()`` carries the same
counts.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Any

from oim_tpu_torch.common import events
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.data import objectstore

# Extent kinds whose content identity is cheaply verifiable. Anything else
# (test-registered reader kinds, mutable host buffers) is uncacheable.
_FINGERPRINTABLE = ("file", "object")


def fingerprint_source(src) -> tuple | None:
    """Content fingerprint of an ExtentSource, or None when the source's
    identity can't be verified cheaply. Files fingerprint as (locator,
    offset, length, mtime_ns, size): a rewritten file changes mtime/size
    and therefore the key. Objects fingerprint as (locator, offset,
    length, size, ETag, Last-Modified) by a HEAD: a same-size re-upload
    moves a validator, and a store that sends neither makes the source
    uncacheable (a stale hit is worse than a restage)."""
    parts = []
    stats: dict[str, tuple] = {}
    for e in src.extents:
        if e.kind not in _FINGERPRINTABLE:
            return None
        if e.kind == "file":
            st = stats.get(e.locator)
            if st is None:
                try:
                    s = os.stat(e.locator)
                except OSError:
                    return None
                st = stats[e.locator] = (s.st_mtime_ns, s.st_size)
            parts.append(("file", e.locator, e.offset, e.length) + st)
        else:
            val = stats.get(e.locator)
            if val is None:
                try:
                    val = stats[e.locator] = objectstore.object_validators(
                        e.locator, src.headers)
                except OSError:  # the stage itself surfaces I/O errors
                    return None
            if not any(val):
                return None  # no freshness signal: never risk a stale hit
            parts.append(("object", e.locator, e.offset, e.length, e.object_size) + val)
    return tuple(parts)


def content_key(
    params_kind: str, fingerprint: tuple, spec_bytes: bytes,
    placement_sig: tuple,
) -> tuple[str, tuple[str, ...], str]:
    """(digest key, locator tuple, source signature) for a fingerprinted
    source staged under ``spec_bytes`` into ``placement_sig``. The digest
    is what the cache indexes on; the locators + source signature (a
    digest of the CONTENT fingerprint alone, spec/placement excluded)
    drive stale-entry invalidation."""
    h = hashlib.sha256(
        repr((params_kind, fingerprint, spec_bytes, placement_sig)).encode()
    ).hexdigest()[:24]
    src_sig = hashlib.sha256(repr(fingerprint).encode()).hexdigest()[:24]
    return h, tuple(sorted({p[1] for p in fingerprint})), src_sig


class CacheEntry:
    """One resident staged tensor. ``pins`` counts mapped volumes (and
    in-flight inserts) referencing it; only idle entries (pins == 0) may
    be evicted."""

    __slots__ = ("key", "array", "nbytes", "locators", "pins", "device_id",
                 "source_sig")

    def __init__(self, key: str, array: Any, nbytes: int,
                 locators: tuple[str, ...], device_id: int = -1,
                 source_sig: str = ""):
        self.key = key
        self.array = array
        self.nbytes = nbytes
        self.locators = locators
        self.pins = 1
        self.device_id = device_id
        self.source_sig = source_sig


def _default_capacity() -> int:
    try:
        return int(os.environ.get("OIM_STAGE_CACHE_BYTES", 1 << 30))
    except ValueError:
        return 1 << 30


class StageCache:
    """Thread-safe LRU of CacheEntry, bounded by ``capacity_bytes`` of
    resident (idle + pinned) tensor bytes. ``capacity_bytes=0`` disables
    caching entirely (every lookup misses, inserts are dropped)."""

    def __init__(self, capacity_bytes: int | None = None):
        self.capacity_bytes = (
            _default_capacity() if capacity_bytes is None else capacity_bytes)
        self._entries: OrderedDict[str, CacheEntry] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._counts = {"hits": 0, "misses": 0, "evictions": 0}

    # -- core --------------------------------------------------------------

    def lookup(self, key: str) -> CacheEntry | None:
        """Pin and return the entry for ``key``, or None (counted as a
        miss only by callers that then stage, through ``count``)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            entry.pins += 1
            self._entries.move_to_end(key)
            return entry

    def count(self, hit: bool) -> None:
        """Record a staging request served from the cache or not."""
        with self._lock:
            self._counts["hits" if hit else "misses"] += 1
        (M.STAGE_CACHE_HITS if hit else M.STAGE_CACHE_MISSES).inc()

    def insert(self, key: str, array: Any, nbytes: int,
               locators: tuple[str, ...], device_id: int = -1,
               source_sig: str = "") -> CacheEntry:
        """Insert a freshly staged tensor, returned pinned. Evicts idle
        entries (stale same-locator ones first, then LRU) to fit
        ``capacity_bytes``; a tensor too big for the capacity is returned
        uncached (pins=1, not indexed) so the volume still works."""
        entry = CacheEntry(key, array, nbytes, locators, device_id,
                           source_sig)
        if self.capacity_bytes == 0:
            return entry
        with self._lock:
            if key in self._entries:
                # Raced insert of the same content: keep the incumbent
                # resident, hand the caller its own (uncached) copy.
                return entry
            # A DIFFERENT source signature on a shared locator means the
            # source changed on disk: the old bytes can never match again.
            stale = [
                k for k, e in self._entries.items()
                if e.pins == 0 and e.source_sig != source_sig
                and set(e.locators) & set(locators)
            ]
            for k in stale:
                self._evict_locked(k)
            while (self._bytes + nbytes > self.capacity_bytes
                   and self._evict_lru_locked()):
                pass
            if self._bytes + nbytes > self.capacity_bytes:
                return entry  # pinned entries alone exceed capacity
            self._entries[key] = entry
            self._bytes += nbytes
            M.STAGE_CACHE_BYTES.set(self._bytes)
            M.STAGE_CACHE_ENTRIES.set(len(self._entries))
            return entry

    def release(self, entry: CacheEntry, keep: bool = True) -> None:
        """Drop one pin. With ``keep=False`` (or for entries that never
        made it into the index) an idle entry's tensor is dropped at once;
        otherwise it stays resident for the next hit."""
        with self._lock:
            entry.pins -= 1
            if entry.pins > 0:
                return
            if self._entries.get(entry.key) is not entry:
                entry.array = None
                return
            if not keep:
                self._evict_locked(entry.key)

    # -- eviction ----------------------------------------------------------

    def _evict_locked(self, key: str) -> None:
        entry = self._entries.pop(key)
        self._bytes -= entry.nbytes
        self._counts["evictions"] += 1
        M.STAGE_CACHE_EVICTIONS.inc()
        # Flight recorder: an eviction explains why a later publish that
        # "should" have been an O(1) hit restaged from source instead.
        events.emit(events.STAGE_CACHE_EVICTION, key=key,
                    bytes=entry.nbytes, still_pinned=entry.pins > 0)
        M.STAGE_CACHE_BYTES.set(self._bytes)
        M.STAGE_CACHE_ENTRIES.set(len(self._entries))
        if entry.pins == 0:
            entry.array = None
        # else: still mapped somewhere; the last release() drops it.

    def _evict_lru_locked(self) -> bool:
        for key, entry in self._entries.items():  # insertion order = LRU
            if entry.pins == 0:
                self._evict_locked(key)
                return True
        return False

    def evict_idle(self) -> int:
        """Drop every idle entry NOW (the allocation-failure pressure
        valve: a backend that hits device OOM evicts and retries once).
        Returns bytes freed."""
        with self._lock:
            before = self._bytes
            while self._evict_lru_locked():
                pass
            return before - self._bytes

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "pinned": sum(1 for e in self._entries.values() if e.pins),
                "capacity_bytes": self.capacity_bytes,
                **self._counts,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
