"""Staging-backend abstraction (``oim_tpu/controller/backend.py``).

A backend stages a data source into its memory domain (host memory for
``MallocBackend``, a device's memory for ``CUDABackend``) asynchronously:
``stage`` returns at once and a background thread fills the
``StagedVolume``; consumers wait on it or poll its ``StageState``.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Protocol

import numpy as np
import torch

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
