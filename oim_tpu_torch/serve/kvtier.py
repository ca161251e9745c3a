"""Host-RAM tier for the prefix KV store (``oim_tpu/serve/kvtier.py``):
demote instead of drop. The serving engine's tier sets the
``oim_kvtier_host_*`` gauges and counts demotions and promotions;
``HostTier.stats()`` carries the same counts.

    hbm (PagePool page, zero-copy shareable)
      |  demote: D2H copy on eviction of a store-only page
      v
    host (numpy K/V block in this LRU, bounded by kv_host_bytes)
      |  promote: H2D copy into a freshly allocated page on a hit
      v
    volume (serve/kvvolume.py: a content-addressed blob on a controller;
            an adoption writes a whole fetched run with ``stage_pages``)

A block lives in exactly ONE tier: demotion captures the bytes before the
device page frees, promotion pops the host entry after the bytes land back
on the device. Both copies are bit-exact (bf16 blocks travel as their
``uint16`` bits), so a promoted block holds exactly what a fresh prefill
would recompute.

Threading: ``HostTier`` is lock-protected, but ``page_kv``,
``stage_page`` and ``stage_pages`` touch the engine's device pool and run
on the engine thread only (its admission and retirement paths; other
threads read the pool through the engine's command queue). On a CUDA pool the
copies go through pinned host buffers: D2H with ``non_blocking=True`` and
a stream synchronisation before numpy reads the buffer; H2D from a pinned
staging buffer.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from oim_tpu_torch.common import metrics as M


class _HostBlock:
    """One demoted block: K and V for ``page_tokens`` positions of one
    chain hash, as host numpy arrays [L, page_tokens, kv_heads, hd]."""

    __slots__ = ("key", "k", "v", "nbytes")

    def __init__(self, key: str, k: np.ndarray, v: np.ndarray):
        self.key = key
        self.k = k
        self.v = v
        self.nbytes = int(k.nbytes + v.nbytes)


class HostTier:
    """Thread-safe LRU of demoted prefix blocks, bounded by
    ``capacity_bytes`` of host RAM. ``capacity_bytes=0`` disables the tier
    (puts are dropped)."""

    def __init__(self, capacity_bytes: int, track_metrics: bool = True):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.track_metrics = track_metrics
        self._blocks: OrderedDict[str, _HostBlock] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.demotions = 0
        self.promotions = 0
        if track_metrics:
            M.KVTIER_HOST_PAGES.set(0)
            M.KVTIER_HOST_BYTES.set(0)

    def put(self, key: str, k: np.ndarray, v: np.ndarray) -> bool:
        """Admit one demoted block (MRU), LRU-evicting to fit. False when
        the tier is disabled or the block alone exceeds the budget."""
        block = _HostBlock(key, k, v)
        with self._lock:
            if block.nbytes > self.capacity_bytes:
                return False
            old = self._blocks.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            while (self._bytes + block.nbytes > self.capacity_bytes
                   and self._blocks):
                _, victim = self._blocks.popitem(last=False)
                self._bytes -= victim.nbytes
            self._blocks[key] = block
            self._bytes += block.nbytes
            self.demotions += 1
            self._update_locked()
        if self.track_metrics:
            M.KVTIER_DEMOTIONS.inc()
        return True

    def get(self, key: str) -> tuple[np.ndarray, np.ndarray] | None:
        """The block's (k, v), MRU-touched; None when absent."""
        with self._lock:
            block = self._blocks.get(key)
            if block is None:
                return None
            self._blocks.move_to_end(key)
            return block.k, block.v

    def pop(self, key: str, promoted: bool = True) -> bool:
        """Remove a block: the promotion's second half (move semantics).
        Returns whether the key was present."""
        with self._lock:
            block = self._blocks.pop(key, None)
            if block is None:
                return False
            self._bytes -= block.nbytes
            if promoted:
                self.promotions += 1
            self._update_locked()
        if promoted and self.track_metrics:
            M.KVTIER_PROMOTIONS.inc()
        return True

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._blocks

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def hot(self, n: int) -> list[str]:
        """The ``n`` most-recently-used keys, hottest first."""
        with self._lock:
            keys = list(self._blocks.keys())
        return keys[::-1][:n]

    def evict_all(self) -> int:
        """Drop every block NOW (drain/census). Returns blocks dropped."""
        with self._lock:
            n = len(self._blocks)
            self._blocks.clear()
            self._bytes = 0
            self._update_locked()
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._blocks),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "demotions": self.demotions,
                "promotions": self.promotions,
            }

    def _update_locked(self) -> None:
        if self.track_metrics:
            M.KVTIER_HOST_PAGES.set(len(self._blocks))
            M.KVTIER_HOST_BYTES.set(self._bytes)


# -- device <-> host block movement (engine-thread only) -----------------

_BITS = {2: (torch.int16, np.uint16), 4: (torch.int32, np.uint32)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device (or CPU) tensor's bytes as a host numpy array of unsigned
    ints of its width: exact for every dtype, bf16 included."""
    as_int, np_dtype = _BITS[t.element_size()]
    bits = t.view(as_int)
    if t.is_cuda:
        buf = torch.empty(bits.shape, dtype=as_int, pin_memory=True)
        buf.copy_(bits, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()  # before numpy reads it
    else:
        buf = bits.clone()
    return buf.numpy().view(np_dtype)


def _to_device(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_to_host``: ``arr``'s bytes as a tensor of
    ``like``'s dtype, staged in pinned memory for a CUDA target."""
    as_int, np_dtype = _BITS[like.element_size()]
    src = torch.from_numpy(np.ascontiguousarray(arr).view(np_dtype).view(
        np.dtype(f"int{8 * like.element_size()}")))
    if like.is_cuda:
        buf = torch.empty(src.shape, dtype=as_int, pin_memory=True)
        buf.copy_(src)
        src = buf.to(like.device, non_blocking=True)
    return src.view(like.dtype)


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool's blocks read as on the host: the pool's own
    where numpy has it, bf16 as its ``uint16`` bits."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def page_kv(cache: dict, page: int) -> tuple[np.ndarray, np.ndarray]:
    """D2H: one physical page's (k, v) as host arrays [L, page_tokens,
    kv_heads, head_dim] of the pool's bits. Engine-thread only."""
    return _to_host(cache["k"][:, page]), _to_host(cache["v"][:, page])


def stage_page(cache: dict, page: int, k: np.ndarray,
               v: np.ndarray) -> dict:
    """H2D: write (k, v) into physical ``page`` of the device pool, in
    place; returns the pool. Engine-thread only."""
    for name, arr in (("k", k), ("v", v)):
        cache[name][:, page] = _to_device(arr, cache[name])
    return cache


def stage_pages(cache: dict, pages: list, ks: list, vs: list) -> dict:
    """H2D: write N blocks into N pool pages at once, in place; returns the
    pool. The ks and vs are stacked along the page axis into ONE host
    buffer [2, L, N, page_tokens, kv_heads, hd] (pinned for a CUDA pool),
    copied to the device in one transfer and written by one ``index_copy_``
    a side on the pool's page axis: a peer-fetch adoption stages whole
    chains, and per-page dispatch would eat a good slice of the prefill it
    saves. A block whose shape or element size is not the pool's raises
    ValueError before anything is written. Engine-thread only."""
    if len(pages) == 1:
        return stage_page(cache, pages[0], ks[0], vs[0])
    pool = cache["k"]
    as_int, np_dtype = _BITS[pool.element_size()]
    shape = (2, pool.shape[0], len(pages)) + tuple(pool.shape[2:])
    host = torch.empty(shape, dtype=as_int, pin_memory=pool.is_cuda)
    bits = host.numpy().view(np_dtype)
    for side, blocks in enumerate((ks, vs)):
        for i, block in enumerate(blocks):
            block = np.asarray(block)
            if block.dtype.itemsize != bits.itemsize:
                raise ValueError(
                    f"a {block.dtype} block cannot stage into a {pool.dtype} pool")
            bits[side, :, i] = block.view(np_dtype)
    staged = host.to(pool.device, non_blocking=True).view(pool.dtype)
    index = torch.tensor(pages, dtype=torch.long, device=pool.device)
    cache["k"].index_copy_(1, index, staged[0])
    cache["v"].index_copy_(1, index, staged[1])
    return cache
