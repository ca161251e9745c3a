"""Host-side accounting for the paged KV cache (``oim_tpu/serve/pagepool.py``):
page ids, refcounts, and the free list. The serving pool sets the
``oim_serve_kv_pages_*`` gauges; every count is also in ``stats()``.

The device tensors, {"k","v"} of [L, n_pages, page_tokens, kv_heads,
head_dim] from ``models/generate.py init_page_pool``, belong to the engine.
This class owns what the HOST must know about them: which physical pages
are free, how many references each allocated page holds (a live slot's
page table and the prefix store each count as one), and the occupancy
watermarks.

The refcount is the whole sharing story. A prefix-cache hit is ``ref()``
plus a page-table write (no K/V moves); slot retirement is ``unref()`` of
every page the slot mapped; donating a prompt block to the prefix store
is the store taking its own ``ref()`` before the slot drops its one. A
page returns to the free list exactly when the last reference goes, so
nothing can free a page a live slot still reads.

Physical page 0 is reserved as scratch: unmapped page-table entries point
at it and idle decode rows write their discarded K/V into it, so it is
never allocated, never refcounted, and its content is garbage by design.
"""

from __future__ import annotations

import threading
from typing import Iterable

from oim_tpu_torch.common import metrics as M


class PagePool:
    """Thread-safe page-id allocator over ``n_pages`` usable pages
    (physical ids 1..n_pages; 0 is the reserved scratch page).

    ``page_bytes`` is the device footprint of one page's K+V across all
    layers, the unit the prefix store's byte budget is charged in.
    """

    def __init__(self, n_pages: int, page_tokens: int, page_bytes: int = 0,
                 track_metrics: bool = True, tier: str = "hbm"):
        if n_pages < 1:
            raise ValueError(f"need >= 1 usable page, got {n_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.page_bytes = page_bytes
        # This pool's rung in the KV tier lattice (serve/kvtier.py): the
        # device pool is "hbm"; sibling tiers register a stats callable so
        # ONE census call covers every rung (a block lives in exactly one).
        self.tier = tier
        self._tiers: dict[str, object] = {}
        # The oim_serve_kv_pages_* gauges describe the replica's ONE
        # serving pool; a secondary pool (the speculative-decoding draft
        # model's) keeps its census in stats() only.
        self.track_metrics = track_metrics
        # pop() from the end => pages allocate 1, 2, 3, ...: deterministic
        # tests and readable page tables.
        self._free = list(range(n_pages, 0, -1))
        self._ref = [0] * (n_pages + 1)
        self._shared = 0  # pages with refcount >= 2
        self._peak_used = 0
        self._lock = threading.Lock()
        if track_metrics:
            M.SERVE_KV_PAGES_TOTAL.set(n_pages)
            M.SERVE_KV_PAGES_USED.set(0)
            M.SERVE_KV_PAGES_SHARED.set(0)

    # -- allocation --------------------------------------------------------

    def alloc(self, count: int) -> list[int] | None:
        """``count`` fresh pages at refcount 1, or None when the pool
        cannot satisfy the request (the caller backpressures)."""
        if count < 0:
            raise ValueError(f"count must be >= 0, got {count}")
        with self._lock:
            if count > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(count)]
            for p in pages:
                self._ref[p] = 1
            self._update_locked()
            return pages

    def ref(self, pages: Iterable[int]) -> None:
        """One more reference on each page (all must be allocated)."""
        with self._lock:
            for p in pages:
                if self._ref[p] < 1:
                    raise ValueError(f"ref of unallocated page {p}")
                self._ref[p] += 1
                if self._ref[p] == 2:
                    self._shared += 1
            self._update_locked()

    def unref(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list. Returns how many pages were actually freed."""
        freed = 0
        with self._lock:
            for p in pages:
                if self._ref[p] < 1:
                    raise ValueError(f"unref of unallocated page {p}")
                self._ref[p] -= 1
                if self._ref[p] == 1:
                    self._shared -= 1
                elif self._ref[p] == 0:
                    self._free.append(p)
                    freed += 1
            self._update_locked()
        return freed

    # -- introspection -----------------------------------------------------

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref[page]

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return self.n_pages - len(self._free)

    def register_tier(self, name: str, stats_fn) -> None:
        """Attach a sibling tier's census: ``stats_fn()`` returns a dict
        with at least ``entries`` and ``bytes``; it rides every
        ``stats()`` under ``tiers[name]``."""
        self._tiers[name] = stats_fn

    def stats(self) -> dict:
        with self._lock:
            used = self.n_pages - len(self._free)
            out = {
                "tier": self.tier,
                "total_pages": self.n_pages,
                "used_pages": used,
                "free_pages": len(self._free),
                "shared_pages": self._shared,
                "peak_used_pages": self._peak_used,
                "page_tokens": self.page_tokens,
                "page_bytes": self.page_bytes,
            }
            tiers = dict(self._tiers)
        if tiers:
            out["tiers"] = {name: fn() for name, fn in tiers.items()}
        return out

    def _update_locked(self) -> None:
        used = self.n_pages - len(self._free)
        if used > self._peak_used:
            self._peak_used = used
        if self.track_metrics:
            M.SERVE_KV_PAGES_USED.set(used)
            M.SERVE_KV_PAGES_SHARED.set(self._shared)
