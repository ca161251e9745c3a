"""Staging-backend abstraction (``oim_tpu/controller/backend.py``).

A backend stages a data source into its memory domain (host memory for
``MallocBackend``, a device's memory for ``CUDABackend``) asynchronously:
``stage`` returns at once and a background thread fills the
``StagedVolume``; consumers wait on it or poll its ``StageState``.

``read_window`` copies a byte range of a staged array to the host: the
data window that ``ControllerService.ReadVolume`` streams and that a
local-mode ``Feeder`` reads. It moves only the window's bytes off the
device, and it needs neither grpcio nor protobuf.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Protocol

import numpy as np
import torch

from oim_tpu_torch.data import plane
from oim_tpu_torch.spec import ArraySpec, StageStatus


class StageState(enum.Enum):
    STAGING = "staging"
    READY = "ready"
    FAILED = "failed"


@dataclasses.dataclass
class StagedVolume:
    """Tracks one staged volume; thread-safe via the embedded condition."""

    volume_id: str
    params_key: bytes  # serialized request params, the idempotency fingerprint
    spec: ArraySpec
    state: StageState = StageState.STAGING
    error: str = ""
    cancelled: bool = False  # set by unstage; the stager drops its own tensor
    bytes_staged: int = 0
    total_bytes: int = 0
    started_at: float = dataclasses.field(default_factory=time.monotonic)
    finished_at: float = 0.0
    device_id: int = -1
    array: Any = None  # torch.Tensor: on the host (malloc) or the device
    # Set when ``array`` is owned by the backend's content-addressed stage
    # cache: unstage releases the pin instead of dropping the tensor, so a
    # re-publish of identical content re-mounts it in O(1).
    cache_entry: Any = None
    cond: threading.Condition = dataclasses.field(default_factory=threading.Condition)

    def mark_ready(self, array: Any, nbytes: int, device_id: int = -1,
                   cache_entry: Any = None) -> bool:
        """Returns False if the volume was unstaged while staging ran: the
        caller (the staging thread) must then drop the tensor itself (or
        release its cache pin), so a racing unstage never strands device
        memory. ``cache_entry`` is published under the same lock as
        ``array`` so unstage sees both or neither."""
        with self.cond:
            if self.cancelled:
                self.finished_at = time.monotonic()
                self.state = StageState.FAILED
                self.error = "unmapped during staging"
                self.cond.notify_all()
                return False
            self.array = array
            self.cache_entry = cache_entry
            self.bytes_staged = nbytes
            self.total_bytes = nbytes
            self.device_id = device_id
            self.finished_at = time.monotonic()
            self.state = StageState.READY
            self.cond.notify_all()
            return True

    def mark_failed(self, error: str) -> None:
        with self.cond:
            self.error = error
            self.finished_at = time.monotonic()
            self.state = StageState.FAILED
            self.cond.notify_all()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until staging finished (ready or failed); False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while self.state == StageState.STAGING:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self.cond.wait(remaining)
        return True

    @property
    def gbps(self) -> float:
        end = self.finished_at or time.monotonic()
        elapsed = max(end - self.started_at, 1e-9)
        return self.bytes_staged / elapsed / 1e9

    def status(self) -> StageStatus:
        return StageStatus(ready=self.state == StageState.READY,
                           bytes_staged=self.bytes_staged, gbps=self.gbps,
                           error=self.error)


_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name or spelling ("float32", "f4",
    "<f4", "i4", "float"), resolved by ``np.dtype`` as the JAX package
    does; "bfloat16" by name. ValueError for a name numpy does not know,
    a dtype torch lacks and a non-native byte order."""
    if name == "bfloat16":
        return torch.bfloat16
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"dtype {name!r} has no torch dtype the port stages "
                         "(numpy does not know the name)") from None
    if not dtype.isnative:
        raise ValueError(f"dtype {name!r} has no torch dtype the port stages: "
                         f"{dtype.str} is not in native byte order")
    try:
        return _DTYPES[dtype.name]
    except KeyError:
        raise ValueError(f"dtype {name!r} has no torch dtype the port stages "
                         f"(known: bfloat16, {', '.join(_DTYPES)})") from None


def numpy_to_torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype in native byte order."""
    dtype = np.dtype(dtype)
    if not dtype.isnative:
        raise ValueError(f"dtype {dtype.str} is not in native byte order")
    return torch_dtype(dtype.name)


def spec_dtype(spec: ArraySpec) -> torch.dtype:
    """torch dtype for an ArraySpec; an empty dtype is uint8."""
    return torch_dtype(spec.dtype or "uint8")


def reshape_to_spec(data: torch.Tensor, spec: ArraySpec) -> torch.Tensor:
    """View host data as the requested dtype/shape; -1 dims inferred.

    An empty dtype keeps the source's own dtype (so e.g. .npy files carry
    their type through); an empty shape keeps the source's shape.
    """
    dtype = spec_dtype(spec) if spec.dtype else data.dtype
    flat = (data.reshape(-1).contiguous().view(torch.uint8).view(dtype)
            if data.dtype != dtype else data)
    shape = tuple(int(d) for d in spec.shape) or tuple(flat.shape)
    return flat.reshape(shape)


class StagingBackend(Protocol):
    """What a controller needs from its memory domain."""

    def provision(self, name: str, size: int) -> None: ...

    def check(self, name: str) -> bool: ...

    def stage(self, volume: StagedVolume, params_kind: str, params: Any) -> None:
        """Start staging asynchronously; fill ``volume`` when done."""
        ...

    def unstage(self, volume: StagedVolume) -> None: ...


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype ("int32", "bfloat16"): what
    the JAX package writes into a ReadVolume chunk's spec."""
    return str(dtype).removeprefix("torch.")


def numpy_dtype(name: str) -> np.dtype:
    """The numpy dtype of a spec's dtype name ("" is uint8); ValueError for
    bfloat16, which numpy lacks (its bytes stay readable as uint8)."""
    if name == "bfloat16":
        raise ValueError("a bfloat16 volume has no numpy dtype: read its bytes "
                         "with read_window or Feeder.fetch_window")
    return np.dtype(name or "uint8")


def array_shape(array) -> tuple[int, ...]:
    """The global shape of a staged tensor or ``plane.Placed``."""
    return tuple(int(d) for d in array.shape)


def volume_nbytes(array) -> int:
    """The bytes of a staged tensor's or ``plane.Placed``'s global array."""
    n = 1
    for d in array_shape(array):
        n *= d
    return n * array.dtype.itemsize


def read_window(array, offset: int, length: int = 0) -> tuple[np.ndarray, int]:
    """(the bytes [offset, end) of ``array``'s row-major global buffer as a
    uint8 numpy array, the array's total bytes); ``end`` is the total for
    ``length == 0``, else ``min(offset + length, total)``.

    ``array`` is a staged tensor (host or device) or a ``plane.Placed``.
    Only the elements the window touches leave the device, through a
    ``uint8`` view (every dtype, bfloat16 too, without numpy knowing it).
    A ``Placed`` over a ``LocalMesh`` gives the global array's bytes from
    its shards, slice by slice, without assembling the array; one that
    holds only this rank's slice of a mesh raises ValueError, as JAX
    refuses to read an array that is not fully addressable."""
    total = volume_nbytes(array)
    itemsize = array.dtype.itemsize
    if isinstance(array, plane.Placed):
        _check_addressable(array)
    start = int(offset)
    end = total if length == 0 else min(start + int(length), total)
    if start >= end:
        return np.zeros((0,), np.uint8), total
    e0, e1 = start // itemsize, -(-end // itemsize)
    lo, hi = start - e0 * itemsize, end - e0 * itemsize
    if isinstance(array, plane.Placed):
        host = _placed_window(array, e0 * itemsize, e1 * itemsize, itemsize)
    else:
        piece = array.reshape(-1)[e0:e1]
        host = piece.contiguous().view(torch.uint8).cpu()
    return host.numpy()[lo:hi], total


def _check_addressable(array: "plane.Placed") -> None:
    """ValueError unless the shards this process holds cover ``array``."""
    imap = array.placement.addressable_indices_map(array.shape)
    held = {tuple((s.start, s.stop) for s in imap[c]) for c, _, _ in array.shards}
    pieces = 1
    if array.shards:
        for d in range(len(array.shape)):
            pieces *= array.placement.parts(array.shards[0][0], d)[0]
    if len(held) < pieces:
        raise ValueError(
            f"the volume is placed over a mesh of which this process holds "
            f"{len(held)} of {pieces} slices: a window needs the whole array")


def _placed_window(array: "plane.Placed", lo: int, hi: int,
                   itemsize: int) -> torch.Tensor:
    """The global bytes [lo, hi) (element-aligned) of a ``Placed``,
    copied run by run out of each distinct shard slice."""
    imap = array.placement.addressable_indices_map(array.shape)
    shape = array_shape(array)
    out = torch.empty(hi - lo, dtype=torch.uint8)
    seen = set()
    for coord, _, shard in array.shards:
        index = imap[coord]
        key = tuple((s.start, s.stop) for s in index)
        if key in seen:
            continue
        seen.add(key)
        flat = shard.reshape(-1).view(torch.uint8)
        for glo, ghi, local in _runs_in(shape, index, itemsize, lo, hi):
            out[glo - lo:ghi - lo].copy_(flat[local:local + ghi - glo])
    return out


def _runs_in(shape, index, itemsize: int, lo: int, hi: int):
    """(global byte start, global byte stop, byte offset in the slice's own
    buffer) of each part of the slice ``index`` of a row-major array of
    ``shape`` that falls in the global bytes [lo, hi). The slice's runs
    rise in the global buffer as they do in its own, so a binary search
    finds the first run the window touches and only those runs are
    visited."""
    dims = len(shape)
    index = tuple(index) + (slice(None),) * (dims - len(index))
    starts = [index[d].start or 0 for d in range(dims)]
    stops = [shape[d] if index[d].stop is None else index[d].stop for d in range(dims)]
    t = dims
    while t > 0 and starts[t - 1] == 0 and stops[t - 1] == shape[t - 1]:
        t -= 1
    strides = [1] * dims
    for d in range(dims - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    if t == 0:
        yield lo, hi, lo
        return
    run = (stops[t - 1] - starts[t - 1]) * strides[t - 1] * itemsize
    radix = [stops[d] - starts[d] for d in range(t - 1)]
    n_runs = 1
    for r in radix:
        n_runs *= r

    def base(k: int) -> int:
        elems = starts[t - 1] * strides[t - 1]
        for d in range(t - 2, -1, -1):
            k, c = divmod(k, radix[d])
            elems += (starts[d] + c) * strides[d]
        return elems * itemsize

    a, b = 0, n_runs  # the first run that ends after lo
    while a < b:
        m = (a + b) // 2
        if base(m) + run <= lo:
            a = m + 1
        else:
            b = m
    for k in range(a, n_runs):
        g = base(k)
        if g >= hi:
            break
        glo, ghi = max(g, lo), min(g + run, hi)
        yield glo, ghi, k * run + glo - g
