"""CUDA staging backend (``oim_tpu/controller/tpu_backend.py``): a volume
on disk into a device tensor.

The data-plane half of the controller: sources lower to extents and ride
the chunked pipeline of ``data/plane.py`` (read-ahead into page-locked
host buffers, copies on a dedicated stream into a preallocated device
tensor), asynchronously, so ``stage`` returns at once and the
volume reports progress until it is READY, and READY means the bytes are
on the device. Named malloc buffers and sources the extent map cannot
express (Fortran-order .npy) take the whole-read path instead.

Placement: an ArraySpec that names mesh axes is staged under a
``plane.Placement`` over the backend's ``mesh`` (a port ``Mesh``: this
rank's slice; a ``plane.LocalMesh``: every card of this process), so one
stage scatters a global array over the mesh, each distinct slice read
once; the volume's array is then a ``plane.Placed``. Shard groups stage
concurrently on ``stage_workers`` threads. A placement whose slices
exceed ``plane.MAX_RUNS`` runs takes the whole-read path, which places
every addressable slice of the host array. A spec that names no axis
lands on one device, picked round robin. Staged arrays live in the
content-addressed stage cache (``keep_cached``), and a device allocation
failure evicts the idle entries and retries once. Each stage runs in a
``stage`` span under the caller's trace, and its duration adds to
``oim_stage_seconds_total``.

The JAX backend converts float64/int64 sources to 32 bits when jax runs
with x64 off; torch has both 64-bit types, so this backend stages their
bytes unchanged.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common import tracing
from oim_tpu_torch.common.meshcoord import MeshCoord
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


def device_mesh_coord(device) -> MeshCoord:
    """The interconnect coordinate of a device: a CUDA card (or the CPU)
    has none, so every component is UNSET, as the JAX package gives off a
    TPU."""
    return MeshCoord()


class CUDABackend(MallocBackend):
    """MallocBackend (named host buffers still work) with device
    placement, the chunked staging pipeline and a stage cache holding
    device arrays. ``device="cpu"`` stages into CPU tensors through the
    same pipeline (no pinned memory, no copy stream).

    ``mesh`` (a port ``Mesh`` or a ``plane.LocalMesh``) places the specs
    that name mesh axes; a spec that names none lands on ``device`` (every
    card, round robin, for a bare "cuda"); ``stage_workers`` is the
    shard-group pool's width (None: the plane's default)."""

    def __init__(self, device="cuda", mesh=None, chunk_bytes: int = 64 << 20,
                 stage_workers: int | None = None, cache_bytes: int | None = None,
                 keep_cached: bool = True):
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
        self.mesh = mesh
        self.chunk_bytes = chunk_bytes
        # Each group in flight holds its own read-ahead buffers.
        self.stage_workers = stage_workers
        self._next_device = 0
        self._device_lock = threading.Lock()

    def _pick_device(self) -> torch.device:
        """Round-robin across the backend's devices."""
        with self._device_lock:
            dev = self.devices[self._next_device % len(self.devices)]
            self._next_device += 1
            return dev

    def _sharding_for(self, spec: ArraySpec) -> plane.Placement | torch.device:
        """The spec's placement over the mesh, or one device when it names
        no axis."""
        if any(spec.sharding_axes):
            if self.mesh is None:
                # Never silently collapse a requested sharding onto one
                # device: that either runs out of memory or trains on
                # misplaced data.
                raise ValueError(
                    f"spec requests sharding over axes {list(spec.sharding_axes)} "
                    "but this controller has no mesh configured")
            return plane.Placement.of(self.mesh, spec.sharding_axes)
        return self._pick_device()

    def _placement_sig(self, spec: ArraySpec) -> tuple:
        """Cache-key component naming the placement domain. A sharded
        placement is pinned to the exact mesh (axis names and sizes, its
        ranks or devices, the spec's axes); a single-device placement keys
        as "device" WITHOUT the round-robin pick, since the resident copy on
        whichever device it landed is the O(1) answer."""
        if any(spec.sharding_axes) and self.mesh is not None:
            placement = plane.Placement.of(self.mesh, spec.sharding_axes)
            return ("mesh", placement.axes, placement.mesh_id, tuple(spec.sharding_axes))
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
            where = self._sharding_for(spec)
            placement = where if isinstance(where, plane.Placement) else None
            with volume.cond:
                volume.total_bytes = plane.placement_bytes(shape, dtype, placement)

            def progress(done: int) -> bool:
                with volume.cond:
                    volume.bytes_staged = done
                    return not volume.cancelled

            arr = plane.stage_source(
                src, dtype=dtype, shape=shape,
                device=None if placement else where, placement=placement,
                chunk_bytes=self.chunk_bytes, progress=progress,
                max_workers=self.stage_workers)
            if arr is None:  # unstaged mid-stage; the destinations are dropped
                volume.mark_failed("unmapped during staging")
                return
            self._finish(volume, arr, keyinfo)

        def work_whole(keyinfo) -> None:
            """Host-materializing fallback: malloc buffers (already in host
            memory), sources the extent map can't express, and placements
            past MAX_RUNS runs, whose every addressable slice is placed from
            the host array. (The JAX backend also sends 64-bit dtypes here;
            torch keeps 64-bit bytes.)"""
            if params_kind == "malloc":
                host = self.buffer(volume.volume_id)
            else:
                host = load_source(params_kind, params)
            host = reshape_to_spec(torch.from_numpy(np.asarray(host)), volume.spec)
            where = self._sharding_for(volume.spec)
            if isinstance(where, plane.Placement):
                arr = plane.place_host(host, where)
            else:
                arr = host.to(where, copy=True)
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
                try:
                    work_plane(src, keyinfo)
                    return
                except plane.PlacementNotLowerable:
                    pass  # a run explosion: the whole-read path still serves it
            work_whole(keyinfo)

        # Captured on the caller's thread: the staging span joins the
        # caller's trace although the work runs on its own thread.
        parent = tracing.current_context()

        def work() -> None:
            with tracing.start_span("stage", parent=parent,
                                    volume=volume.volume_id,
                                    kind=params_kind) as span:
                try:
                    try:
                        attempt()
                        return
                    except Exception as exc:  # noqa: BLE001 - the OOM valve
                        # Device memory pressure: idle cache entries are the
                        # only memory this backend can reclaim; drop them all
                        # and retry once. The retry runs outside this handler,
                        # so the failed attempt's frames (and any tensor they
                        # hold) are gone.
                        if not self._looks_oom(exc) or self.cache.evict_idle() == 0:
                            raise
                    attempt()
                except Exception as exc:  # noqa: BLE001 - reported via the volume
                    volume.mark_failed(str(exc))
                finally:
                    span.finish()
                    M.STAGE_SECONDS.inc(span.duration)

        threading.Thread(target=work, daemon=True).start()

    def _finish(self, volume: StagedVolume, arr, keyinfo) -> None:
        """Insert the staged tensor or ``Placed`` into the content cache
        (when keyed) and mark the volume ready; drops the array or the pin
        if an unstage won the race."""
        if isinstance(arr, plane.Placed):
            device_id, nbytes = arr.device_index, arr.nbytes
        else:
            device_id = arr.device.index if arr.device.index is not None else 0
            nbytes = arr.numel() * arr.element_size()
        entry = None
        if keyinfo is not None:
            entry = self.cache.insert(keyinfo[0], arr, nbytes, keyinfo[1],
                                      device_id=device_id, source_sig=keyinfo[2])
        if not volume.mark_ready(arr, nbytes, device_id=device_id, cache_entry=entry):
            if entry is not None:
                self.cache.release(entry, keep=self.keep_cached)
            elif isinstance(arr, plane.Placed):
                arr.delete()

    def unstage(self, volume: StagedVolume) -> None:
        """MallocBackend's unstage; a ``Placed`` the cache does not own
        also drops every shard, so a caller still holding the ``Placed``
        does not keep the device memory."""
        with volume.cond:
            arr, entry = volume.array, volume.cache_entry
        super().unstage(volume)
        if entry is None and isinstance(arr, plane.Placed):
            arr.delete()

    def coord_of(self, volume: StagedVolume) -> MeshCoord:
        """The interconnect coordinate of the device a volume landed on
        (UNSET components: a CUDA card has none)."""
        if volume.device_id < 0:
            return MeshCoord()
        for d in self.devices:
            if (d.index or 0) == volume.device_id:
                return device_mesh_coord(d)
        return MeshCoord()
