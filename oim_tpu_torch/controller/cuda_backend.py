"""CUDA staging backend (``oim_tpu/controller/tpu_backend.py``): a volume
on disk into a device tensor.

The data-plane half of the controller: sources lower to extents and ride
the chunked pipeline of ``data/plane.py`` (read-ahead into page-locked
host buffers, copies on a dedicated stream into a preallocated device
tensor), asynchronously, so ``stage`` returns at once and the
volume reports progress until it is READY, and READY means the bytes are
on the device. Named malloc buffers and sources the extent map cannot
express (Fortran-order .npy) take the whole-read path instead.

Placement is one device per volume, picked round robin; an ArraySpec that
names mesh axes raises (multi-GPU placement is ROADMAP A.6). Staged
tensors live in the content-addressed stage cache (``keep_cached``), and a
device allocation failure evicts the idle entries and retries once.

The JAX backend converts float64/int64 sources to 32 bits when jax runs
with x64 off; torch has both 64-bit types, so this backend stages their
bytes unchanged.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from oim_tpu_torch.controller.backend import (
    StagedVolume,
    numpy_to_torch_dtype,
    reshape_to_spec,
    spec_dtype,
)
from oim_tpu_torch.controller.malloc_backend import MallocBackend
from oim_tpu_torch.controller.source import load_source
from oim_tpu_torch.data import plane
from oim_tpu_torch.spec import ArraySpec

class CUDABackend(MallocBackend):
    """MallocBackend (named host buffers still work) with device
    placement, the chunked staging pipeline and a stage cache holding
    device tensors. ``device="cpu"`` stages into CPU tensors through the
    same pipeline (no pinned memory, no copy stream)."""

    def __init__(self, device="cuda", chunk_bytes: int = 64 << 20,
                 cache_bytes: int | None = None, keep_cached: bool = True):
        super().__init__(cache_bytes=cache_bytes, keep_cached=keep_cached)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available (pass device='cpu' to stage on the CPU)")
        if device.type == "cuda" and device.index is None:
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        else:
            self.devices = [device]
        self.chunk_bytes = chunk_bytes
        self._next_device = 0
        self._device_lock = threading.Lock()

    def _pick_device(self) -> torch.device:
        """Round-robin across the backend's devices."""
        with self._device_lock:
            dev = self.devices[self._next_device % len(self.devices)]
            self._next_device += 1
            return dev

    def _placement(self, spec: ArraySpec) -> torch.device:
        if any(spec.sharding_axes):
            # Never silently collapse a requested sharding onto one device:
            # that either runs out of memory or trains on misplaced data.
            raise ValueError(
                f"spec requests sharding over axes {list(spec.sharding_axes)} "
                "but this backend places a volume on one device (multi-GPU "
                "placement is not ported)")
        return self._pick_device()

    def _placement_sig(self, spec: ArraySpec) -> tuple:
        """Cache-key component naming the placement domain: "device"
        WITHOUT the round-robin pick, since the resident copy on whichever
        device it landed is the O(1) answer."""
        return ("device",)

    @staticmethod
    def _looks_oom(exc: Exception) -> bool:
        return isinstance(exc, torch.OutOfMemoryError)

    def stage(self, volume: StagedVolume, params_kind: str, params: Any) -> None:
        def work_plane(src, keyinfo) -> None:
            """The uniform data plane (data/plane.py) for every
            extent-lowerable source."""
            spec = volume.spec
            src_dtype = (numpy_to_torch_dtype(src.src_dtype)
                         if src.src_dtype is not None else None)
            dtype = spec_dtype(spec) if spec.dtype else (src_dtype or torch.uint8)
            if src.total_bytes % dtype.itemsize:
                raise ValueError(
                    f"{src.total_bytes} bytes not a multiple of {dtype} itemsize")
            # The source's shape survives only when its dtype does too
            # (reshape_to_spec semantics: a dtype override reinterprets the
            # bytes, so the source's element geometry is meaningless).
            src_shape = src.src_shape if (
                not spec.dtype or src_dtype == dtype) else None
            shape = plane.resolve_shape(
                tuple(int(d) for d in spec.shape) or src_shape,
                src.total_bytes // dtype.itemsize)
            device = self._placement(spec)
            with volume.cond:
                volume.total_bytes = plane.placement_bytes(shape, dtype)

            def progress(done: int) -> bool:
                with volume.cond:
                    volume.bytes_staged = done
                    return not volume.cancelled

            arr = plane.stage_source(src, dtype=dtype, shape=shape, device=device,
                                     chunk_bytes=self.chunk_bytes, progress=progress)
            if arr is None:  # unstaged mid-stage; the destination is dropped
                volume.mark_failed("unmapped during staging")
                return
            self._finish(volume, arr, keyinfo)

        def work_whole(keyinfo) -> None:
            """Host-materializing fallback: malloc buffers (already in host
            memory) and sources the extent map can't express. (The JAX
            backend also sends run explosions of sharded placements and
            64-bit dtypes here; one device is one run, and torch keeps
            64-bit bytes.)"""
            if params_kind == "malloc":
                host = self.buffer(volume.volume_id)
            else:
                host = load_source(params_kind, params)
            host = reshape_to_spec(torch.from_numpy(np.asarray(host)), volume.spec)
            arr = host.to(self._placement(volume.spec), copy=True)
            if arr.is_cuda:
                torch.cuda.synchronize(arr.device)
            self._finish(volume, arr, keyinfo)

        def attempt() -> None:
            src = None
            if params_kind != "malloc":
                src = plane.lower_source(params_kind, params)
            keyinfo = None
            if src is not None:
                keyinfo = self._content_key(params_kind, params, volume.spec, src=src)
            if keyinfo is not None and self._serve_cached(volume, keyinfo[0]):
                return
            if src is not None:
                work_plane(src, keyinfo)
            else:
                work_whole(keyinfo)

        def work() -> None:
            try:
                try:
                    attempt()
                    return
                except Exception as exc:  # noqa: BLE001 - the OOM valve
                    # Device memory pressure: idle cache entries are the only
                    # memory this backend can reclaim; drop them all and retry
                    # once. The retry runs outside this handler, so the failed
                    # attempt's frames (and any tensor they hold) are gone.
                    if not self._looks_oom(exc) or self.cache.evict_idle() == 0:
                        raise
                attempt()
            except Exception as exc:  # noqa: BLE001 - reported via the volume
                volume.mark_failed(str(exc))

        threading.Thread(target=work, daemon=True).start()

    def _finish(self, volume: StagedVolume, arr: torch.Tensor, keyinfo) -> None:
        """Insert the staged tensor into the content cache (when keyed) and
        mark the volume ready; drops the tensor or the pin if an unstage won
        the race."""
        device_id = arr.device.index if arr.device.index is not None else 0
        nbytes = arr.numel() * arr.element_size()
        entry = None
        if keyinfo is not None:
            entry = self.cache.insert(keyinfo[0], arr, nbytes, keyinfo[1],
                                      device_id=device_id, source_sig=keyinfo[2])
        if not volume.mark_ready(arr, nbytes, device_id=device_id,
                                 cache_entry=entry) and entry is not None:
            self.cache.release(entry, keep=self.keep_cached)
