"""Content-addressed prefix KV store over the page pool
(``oim_tpu/serve/prefixcache.py``). Every change of the store sets
``oim_serve_prefix_cache_bytes`` and ``oim_kvtier_hbm_pages``; ``stats()``
carries the same counts.

The store holds no K/V of its own: an entry is a REFERENCE (a refcounted
physical page id, ``serve/pagepool.py``) to the very page a retiring
request's prompt block already lives in, keyed by the chain hash
(``common/prefixhash.py``) so ``a`` and ``a+b`` share the ``a`` blocks.
Retirement donates by taking a reference; an admission that matches m
blocks writes the store's page ids straight into its slot's page table
and prefills only the uncached tail: the hit moves no K/V.

Shared pages are immutable by the engine's write discipline: a slot only
writes the private pages covering its tail and decode positions, so
divergence after a shared prefix lands in fresh pages.

Eviction is LRU under ``capacity_bytes`` of referenced pages, and freeing
is indirect: an evicted entry only DROPS THE STORE'S REFERENCE; the page
returns to the pool when the last referencing slot retires. The
pool-pressure valve ``release()`` therefore skips entries whose pages a
live slot still shares.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Sequence

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.serve.pagepool import PagePool


class PrefixEntry:
    """One cached block: ``page`` holds the K/V for prompt positions
    [i*block, (i+1)*block) of the chain the key names. The store holds one
    pool reference for it."""

    __slots__ = ("key", "page", "nbytes")

    def __init__(self, key: str, page: int, nbytes: int):
        self.key = key
        self.page = page
        self.nbytes = nbytes


class PrefixStore:
    """Thread-safe LRU of PrefixEntry, bounded by ``capacity_bytes`` of
    referenced pages. ``capacity_bytes=0`` disables the store (every
    match is 0, retains are dropped)."""

    def __init__(self, capacity_bytes: int, block: int, pool: PagePool,
                 demote=None):
        if block < 1:
            raise ValueError(f"prefix block must be >= 1, got {block}")
        if pool.page_tokens != block:
            # Zero-copy sharing only works when a prefix block IS a page:
            # the page table maps whole pages.
            raise ValueError(
                f"prefix block ({block} tokens) must equal the KV page "
                f"size ({pool.page_tokens} tokens) for zero-copy "
                f"sharing — set --kv-page-tokens == --prefix-block")
        self.capacity_bytes = capacity_bytes
        self.block = block
        self.pool = pool
        # Tier demotion hook (serve/kvtier.py): ``demote(key, page)`` runs
        # when eviction is about to free a STORE-ONLY page (refcount 1), so
        # the engine can copy the block into the host tier instead of
        # dropping the chain. It runs under the store lock on the calling
        # thread, which the engine keeps on the engine thread.
        self._demote = demote
        self._entries: OrderedDict[str, PrefixEntry] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    # -- lookup ------------------------------------------------------------

    def match(self, hashes: Sequence[str]) -> int:
        """How many LEADING chain hashes are resident (the longest cached
        prefix, in blocks). Touches every matched entry DEEPEST FIRST, so
        the chain's root ends most-recently-used and eviction takes the
        deepest (least shared) blocks first."""
        with self._lock:
            m = 0
            for h in hashes:
                if h not in self._entries:
                    break
                m += 1
            for h in reversed(hashes[:m]):
                self._entries.move_to_end(h)
            return m

    def gather(self, hashes: Sequence[str]) -> list[int] | None:
        """The physical page ids for a matched chain, in block order; None
        if any link was evicted since ``match``. The caller must
        ``pool.ref()`` the pages before anything else can evict them."""
        with self._lock:
            out = []
            for h in hashes:
                entry = self._entries.get(h)
                if entry is None:
                    return None
                out.append(entry.page)
            return out

    # -- retention ---------------------------------------------------------

    def retain(self, hashes: Sequence[str],
               pages: Sequence[int]) -> int:
        """Donate a retiring request's full prompt blocks: for each missing
        hash, take a pool reference on the slot's page for that block and
        index it (no K/V moves). Blocks already resident keep the store's
        page and get the LRU touch. Returns blocks added."""
        if len(pages) < len(hashes):
            raise ValueError(
                f"retain needs one page per hash: {len(hashes)} hashes, "
                f"{len(pages)} pages")
        added = 0
        with self._lock:
            if self.capacity_bytes == 0:
                return 0
            for h, page in zip(hashes, pages):
                if h in self._entries:
                    continue
                entry = PrefixEntry(h, page, self.pool.page_bytes)
                if entry.nbytes > self.capacity_bytes:
                    break  # one block larger than the whole budget
                self.pool.ref([page])
                self._entries[h] = entry
                self._bytes += entry.nbytes
                added += 1
            # Leave the whole chain root-MRU (same stance as match).
            for h in reversed(hashes):
                if h in self._entries:
                    self._entries.move_to_end(h)
            while self._bytes > self.capacity_bytes and self._entries:
                self._evict_lru_locked()
            M.SERVE_PREFIX_CACHE_BYTES.set(self._bytes)
            M.KVTIER_HBM_PAGES.set(len(self._entries))
        return added

    def install(self, key: str, page: int) -> bool:
        """Index ONE block the engine just staged into ``page`` (a tier
        promotion): the store takes its own pool reference, as in
        :meth:`retain`, and the entry lands MRU. False (no ref taken) when
        the store is disabled, the key is resident, or one block exceeds
        the budget."""
        with self._lock:
            if self.capacity_bytes == 0 or key in self._entries:
                return False
            entry = PrefixEntry(key, page, self.pool.page_bytes)
            if entry.nbytes > self.capacity_bytes:
                return False
            self.pool.ref([page])
            self._entries[key] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.capacity_bytes and self._entries:
                self._evict_lru_locked()
            M.SERVE_PREFIX_CACHE_BYTES.set(self._bytes)
            M.KVTIER_HBM_PAGES.set(len(self._entries))
            return True

    # -- eviction ----------------------------------------------------------

    def _evict_lru_locked(self) -> int:
        """Drop the LRU entry's store reference. Returns pages actually
        freed (0 when a live slot still shares the page). A store-only page
        demotes into the host tier BEFORE it frees."""
        _, entry = self._entries.popitem(last=False)
        self._bytes -= entry.nbytes
        if self._demote is not None \
                and self.pool.refcount(entry.page) == 1:
            self._demote(entry.key, entry.page)
        freed = self.pool.unref([entry.page])
        M.SERVE_PREFIX_CACHE_BYTES.set(self._bytes)
        M.KVTIER_HBM_PAGES.set(len(self._entries))
        return freed

    def release(self, want_pages: int) -> int:
        """The pool-pressure valve: walk the LRU end dropping entries whose
        page would ACTUALLY free (the store is the last reference) until
        ``want_pages`` pages returned or nothing freeable remains. Entries
        a live slot still shares are SKIPPED. Returns pages freed."""
        freed = 0
        with self._lock:
            if want_pages <= 0 or not self._entries:
                return 0
            for key in list(self._entries.keys()):  # LRU -> MRU order
                if freed >= want_pages:
                    break
                entry = self._entries[key]
                if self.pool.refcount(entry.page) > 1:
                    continue  # shared with a live slot: frees nothing
                del self._entries[key]
                self._bytes -= entry.nbytes
                if self._demote is not None:
                    self._demote(entry.key, entry.page)
                freed += self.pool.unref([entry.page])
            M.SERVE_PREFIX_CACHE_BYTES.set(self._bytes)
            M.KVTIER_HBM_PAGES.set(len(self._entries))
        return freed

    def evict_all(self) -> int:
        """Drop every store reference NOW. Returns pages freed (pages a
        live slot still maps stay resident until that slot retires)."""
        freed = 0
        with self._lock:
            while self._entries:
                freed += self._evict_lru_locked()
        return freed

    # -- introspection -----------------------------------------------------

    def hot(self, n: int) -> list[str]:
        """The ``n`` most-recently-used chain hashes, hottest first."""
        with self._lock:
            keys = list(self._entries.keys())
        return keys[::-1][:n]

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "block": self.block,
            }

    def page_of(self, key: str) -> int | None:
        """The physical page an entry references."""
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry.page

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries
