"""Host-memory staging backend (``oim_tpu/controller/malloc_backend.py``).

Buffers are named host arrays; staging with ``MallocParams`` stages the
buffer named by the volume id, other params load their source into host
memory. A staged volume's ``array`` is a CPU tensor.

File-backed sources ride the content-addressed stage cache
(``controller/stagecache.py``): an identical re-publish (same bytes on
disk, same spec) returns the resident tensor without re-reading the
source, and ``prestage`` warms the cache ahead of a stage. Named malloc
buffers are mutable and never cached.

Each stage runs in a ``stage`` span under the caller's trace, and its
duration adds to ``oim_stage_seconds_total``.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common import tracing
from oim_tpu_torch.controller import stagecache
from oim_tpu_torch.controller.backend import StagedVolume, reshape_to_spec
from oim_tpu_torch.controller.source import load_source
from oim_tpu_torch.data import plane
from oim_tpu_torch.spec import ArraySpec, spec_bytes


class MallocBackend:
    def __init__(self, cache_bytes: int | None = None,
                 keep_cached: bool = True) -> None:
        self._buffers: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        # keep_cached: entries outlive their volumes (an unstage leaves the
        # staged tensor resident for O(1) re-mount) until LRU/capacity
        # eviction; False frees on last unstage.
        self.cache = stagecache.StageCache(cache_bytes)
        self.keep_cached = keep_cached

    # -- named buffers ----------------------------------------------------

    def provision(self, name: str, size: int) -> None:
        with self._lock:
            existing = self._buffers.get(name)
            if size == 0:
                self._buffers.pop(name, None)
                return
            if existing is not None:
                if existing.nbytes != size:
                    raise ValueError(
                        f"buffer {name!r} exists with size {existing.nbytes}, "
                        f"requested {size}"
                    )
                return
            self._buffers[name] = np.zeros(size, dtype=np.uint8)

    def check(self, name: str) -> bool:
        with self._lock:
            return name in self._buffers

    def buffer(self, name: str) -> np.ndarray:
        with self._lock:
            buf = self._buffers.get(name)
        if buf is None:
            raise KeyError(f"no malloc buffer {name!r}")
        return buf

    # -- stage cache -------------------------------------------------------

    def _placement_sig(self, spec: ArraySpec) -> tuple:
        return ("host",)

    def _content_key(self, params_kind: str, params, spec: ArraySpec,
                     src=None) -> tuple[str, tuple[str, ...], str] | None:
        """(cache key, locators, source signature) for a content-addressable
        source, else None (mutable malloc buffers, unlowerable formats, I/O
        errors: the stage itself will surface those). ``src`` skips
        re-lowering when the caller already holds the ExtentSource."""
        if params_kind == "malloc":
            return None
        if src is None:
            try:
                src = plane.lower_source(params_kind, params)
            except (OSError, ValueError, NotImplementedError):
                return None
        if src is None:
            return None
        fp = stagecache.fingerprint_source(src)
        if fp is None:
            return None
        return stagecache.content_key(params_kind, fp, spec_bytes(spec),
                                      self._placement_sig(spec))

    def _serve_cached(self, volume: StagedVolume, key: str) -> bool:
        """Complete the volume from a resident cache entry; False on miss
        (counted: the caller then stages from source)."""
        entry = self.cache.lookup(key)
        self.cache.count(hit=entry is not None)
        if entry is None:
            return False
        if not volume.mark_ready(entry.array, entry.nbytes,
                                 device_id=entry.device_id,
                                 cache_entry=entry):
            self.cache.release(entry, keep=self.keep_cached)
        return True

    # -- staging ----------------------------------------------------------

    def stage(self, volume: StagedVolume, params_kind: str, params: Any) -> None:
        # Captured on the caller's thread: the staging span joins the
        # caller's trace although the work runs on its own thread.
        parent = tracing.current_context()

        def work() -> None:
            with tracing.start_span("stage", parent=parent,
                                    volume=volume.volume_id,
                                    kind=params_kind) as span:
                try:
                    keyinfo = self._content_key(params_kind, params, volume.spec)
                    if keyinfo is not None and self._serve_cached(volume, keyinfo[0]):
                        return
                    if params_kind == "malloc":
                        host = self.buffer(volume.volume_id)
                    else:
                        host = load_source(params_kind, params)
                    array = reshape_to_spec(torch.from_numpy(np.asarray(host)),
                                            volume.spec)
                    nbytes = array.numel() * array.element_size()
                    entry = None
                    if keyinfo is not None:
                        entry = self.cache.insert(keyinfo[0], array, nbytes,
                                                  keyinfo[1], source_sig=keyinfo[2])
                    if not volume.mark_ready(array, nbytes, cache_entry=entry):
                        if entry is not None:
                            self.cache.release(entry, keep=self.keep_cached)
                except Exception as exc:  # noqa: BLE001 - reported via the volume
                    volume.mark_failed(str(exc))
                finally:
                    span.finish()
                    M.STAGE_SECONDS.inc(span.duration)

        threading.Thread(target=work, daemon=True).start()

    def unstage(self, volume: StagedVolume) -> None:
        """Unstage ``volume``: an in-flight stager drops its own work; a
        cached tensor loses the volume's pin; any other tensor loses the
        volume's reference (its memory is freed once the caller holds no
        reference either)."""
        with volume.cond:
            volume.cancelled = True
            arr, volume.array = volume.array, None
            entry, volume.cache_entry = volume.cache_entry, None
        if arr is not None and entry is not None:
            self.cache.release(entry, keep=self.keep_cached)

    # -- warm-standby ------------------------------------------------------

    def prestage(self, params_kind: str, params: Any,
                 spec: ArraySpec) -> StagedVolume:
        """Warm the content cache without creating a volume: stage into a
        detached StagedVolume and release the pin on completion, leaving the
        entry resident and idle. A later stage of the same content hits in
        O(1). Returns the detached volume so callers can wait on it."""
        volume = StagedVolume(volume_id="~prestage", params_key=b"", spec=spec)
        self.stage(volume, params_kind, params)

        def finish() -> None:
            volume.wait()
            with volume.cond:
                volume.array = None  # uncacheable source: nothing worth keeping
                entry, volume.cache_entry = volume.cache_entry, None
            if entry is not None:
                self.cache.release(entry, keep=True)

        threading.Thread(target=finish, daemon=True).start()
        return volume
