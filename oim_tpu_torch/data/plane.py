"""The uniform data plane (``oim_tpu/data/plane.py``): sources lower to
byte extents, a placement lowers to byte runs, and one chunked
read-ahead -> host-to-device pipeline lands the runs in a device tensor.

- **Sources lower to extents** (``lower_source``): a raw file is one
  extent; a TFRecord path list or a multi-shard webdataset is one extent
  per file laid back to back (framing and tar bytes stay intact); .npy is
  its payload extent with dtype/shape lifted from the header.
- **One device, one run.** Placement is one device, so the staged view
  is the whole volume as a single byte run; the JAX package's lowering of
  sharded placements to many runs (``slice_runs``) returns with sharded
  placement (ROADMAP A.4).
- **One pipeline.** ``iter_view_chunks`` streams the view through a pool
  of page-locked host buffers filled by a read-ahead thread, and
  ``_stage_view`` copies each chunk from its buffer, on a dedicated copy
  stream, straight into its slice of the preallocated destination:
  ``buf[off:off + n].copy_(chunk, non_blocking=True)``. Device peak is the
  volume itself; the JAX package's donated ``dynamic_update_slice``
  needed the volume plus a chunk and a padded tail so that one compiled
  program served every chunk. The JAX package also copies each chunk
  into a second pinned transfer slot first; on the H100 host that extra
  copy ran beside the reads and made the stage slower (PERF.md), so the
  port copies from the reader's buffer.

Fences are CUDA events: one is recorded on the copy stream after each
chunk's copy and synchronised before the reader gets the buffer back, and
the copy stream is synchronised before ``stage_source`` returns, so a
staged tensor holds its bytes on the device when the caller sees it. The
copy stream first waits on the device's current stream, so no copy lands
in a recycled block that earlier work (a training step) still uses.

A tensor has no ``delete()``: on abort or error the stager drops its last
reference to the destination, and the caching allocator takes the memory
back.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import os
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from oim_tpu_torch.data import staging


@dataclasses.dataclass(frozen=True)
class Extent:
    """``length`` bytes at ``offset`` inside a local file ("file"). Tests
    may register extra kinds in ``READERS`` (e.g. throttled readers).
    ``object_size`` belongs to the object-store kind, not ported yet."""

    kind: str
    locator: str
    offset: int
    length: int
    object_size: int | None = None


@dataclasses.dataclass
class ExtentSource:
    """A volume's bytes as ordered extents, plus the numpy dtype/shape
    discovered from the source itself (.npy headers) for specs that leave
    them empty."""

    extents: list[Extent]
    headers: dict[str, str] | None = None
    src_dtype: np.dtype | None = None
    src_shape: tuple[int, ...] | None = None

    def __post_init__(self):
        self.extents = [e for e in self.extents if e.length > 0]
        starts = []
        pos = 0
        for e in self.extents:
            starts.append(pos)
            pos += e.length
        self._starts = starts
        self.total_bytes = pos


# kind -> fn(locator, offset, length, dst_uint8_view, headers)
READERS: dict[str, Callable] = {}


def _read_file_extent(locator, offset, length, dst, headers):
    staging.read_into(locator, dst[:length], offset=offset)


READERS["file"] = _read_file_extent


def read_range(src: ExtentSource, vol_offset: int, dst: np.ndarray) -> None:
    """Fill ``dst`` with volume bytes [vol_offset, vol_offset+len(dst))
    by dispatching the overlapping extents to their readers."""
    need = dst.size
    if vol_offset < 0 or vol_offset + need > src.total_bytes:
        raise ValueError(
            f"range [{vol_offset}, +{need}) outside volume of "
            f"{src.total_bytes} bytes"
        )
    if need == 0:
        return
    i = bisect.bisect_right(src._starts, vol_offset) - 1
    filled = 0
    while filled < need:
        ext = src.extents[i]
        inner = vol_offset + filled - src._starts[i]
        n = min(ext.length - inner, need - filled)
        READERS[ext.kind](ext.locator, ext.offset + inner, n,
                          dst[filled:filled + n], src.headers)
        filled += n
        i += 1


# --------------------------------------------------------- source lowering --


def _file_extent(path: str) -> Extent:
    return Extent("file", str(path), 0, os.path.getsize(path))


def _lower_npy(path: str) -> ExtentSource | None:
    """Payload extent + dtype/shape from the .npy header. Fortran-order
    and object arrays fall back to the whole-read path (np.load)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        try:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        except ValueError:
            return None
        payload = f.tell()
    if fortran or dtype.hasobject:
        return None
    if size - payload != int(np.prod(shape)) * dtype.itemsize:
        return None  # truncated/padded: let np.load produce the real error
    return ExtentSource(
        [Extent("file", str(path), payload, size - payload)],
        src_dtype=dtype, src_shape=tuple(int(d) for d in shape),
    )


def _is_url(path: str) -> bool:
    return path.startswith(("http://", "https://"))


def lower_source(params_kind: str, params) -> ExtentSource | None:
    """MapVolume params -> ExtentSource, or None when the source is not
    extent-lowerable (malloc host buffers, exotic formats) and the caller
    must keep the whole-read path. Runs on the staging thread: missing
    files surface through the volume's status, never at ``stage``."""
    if params_kind == "file":
        fmt = params.format or "raw"
        if fmt == "raw":
            return ExtentSource([_file_extent(params.path)])
        if fmt == "npy":
            return _lower_npy(params.path)
        return None
    if params_kind == "tfrecord":
        return ExtentSource([_file_extent(p) for p in params.paths])
    if params_kind == "webdataset":
        urls = [u for u in params.shard_urls if _is_url(u)]
        if urls:
            raise NotImplementedError(
                f"webdataset shards by URL ({urls[0]}): the object-store "
                "source is not ported yet (ROADMAP A.2)")
        return ExtentSource([_file_extent(u) for u in params.shard_urls])
    if params_kind == "ceph":
        raise NotImplementedError(
            "ceph sources read through the object-store gateway, which is "
            "not ported yet (ROADMAP A.2)")
    return None


def resolve_shape(
    shape: tuple[int, ...] | None, n_elems: int
) -> tuple[int, ...]:
    """Concrete shape for ``n_elems`` elements: None -> flat; a single -1
    dim inferred (numpy reshape semantics, which the whole-read path gets
    for free and the plane must match)."""
    if shape is None or not tuple(shape):
        return (n_elems,)
    shape = tuple(int(d) for d in shape)
    if -1 in shape:
        known = 1
        for d in shape:
            if d != -1:
                known *= d
        if known == 0 or n_elems % known:
            raise ValueError(f"cannot reshape {n_elems} elements to {shape}")
        shape = tuple(n_elems // known if d == -1 else d for d in shape)
    if int(np.prod(shape, dtype=np.int64)) != n_elems:
        raise ValueError(f"cannot reshape {n_elems} elements to {shape}")
    return shape


# ------------------------------------------------------ chunked read-ahead --


class _Cancelled(Exception):
    pass


def _q_get(q: queue.Queue, stop: threading.Event):
    while True:
        try:
            return q.get(timeout=0.1)
        except queue.Empty:
            if stop.is_set():
                raise _Cancelled()


def read_view(
    src: ExtentSource, runs: list[tuple[int, int]], starts: list[int],
    view_off: int, dst: np.ndarray,
) -> None:
    """Fill ``dst`` with view bytes [view_off, view_off+len(dst)), where
    the view is the concatenation of ``runs`` and ``starts`` holds each
    run's prefix sum (its offset inside the view)."""
    need = dst.size
    filled = 0
    i = bisect.bisect_right(starts, view_off) - 1
    while filled < need:
        vol_off, length = runs[i]
        inner = view_off + filled - starts[i]
        n = min(length - inner, need - filled)
        read_range(src, vol_off + inner, dst[filled:filled + n])
        filled += n
        i += 1


def iter_view_chunks(
    src: ExtentSource,
    runs: list[tuple[int, int]],
    chunk_bytes: int = 64 << 20,
    n_buffers: int = 3,
    pad_tail: bool = False,
    on_read_seconds: Callable[[float], None] | None = None,
    pin: bool = False,
) -> Iterator[tuple[int, np.ndarray]]:
    """Stream the concatenation of ``runs`` (the "view") as
    (view_offset, uint8 chunk) pairs.

    A filler thread reads ahead through a pool of ``n_buffers`` host
    buffers (page-locked when ``pin``), so reading chunk N+1 overlaps the
    consumer's copy of chunk N. Each yielded view is valid until the next
    iteration (its buffer is then recycled to the filler).

    ``pad_tail=True`` emits only full-size chunks: the final chunk is
    re-aligned to end exactly at the view's end, overlapping the previous
    chunk (the overlap bytes are re-read and re-land identical values).
    The JAX package needs it for its one compiled update program; nothing
    on the port's staging path uses it (a ``copy_`` takes a short tail).
    ``on_read_seconds`` receives the filler's per-chunk source read time
    (the disk half of the staging breakdown). A reader's error reaches the
    consumer as the same exception.
    """
    total = sum(n for _, n in runs)
    if total == 0:
        return
    chunk_bytes = min(chunk_bytes, total)
    starts = []
    pos = 0
    for _, n in runs:
        starts.append(pos)
        pos += n
    offsets = list(range(0, total, chunk_bytes))
    if pad_tail and offsets and offsets[-1] + chunk_bytes > total:
        offsets[-1] = total - chunk_bytes
    stop = threading.Event()
    free_q: queue.Queue = queue.Queue()
    for _ in range(n_buffers):
        free_q.put(staging.alloc_pinned(chunk_bytes, pin))
    ready_q: queue.Queue = queue.Queue()

    def fill():
        try:
            for view_off in offsets:
                buf = _q_get(free_q, stop)
                used = min(chunk_bytes, total - view_off)
                t0 = time.monotonic()
                read_view(src, runs, starts, view_off, buf[:used])
                if on_read_seconds is not None:
                    on_read_seconds(time.monotonic() - t0)
                ready_q.put(("chunk", buf, used, view_off))
            ready_q.put(("done",))
        except _Cancelled:
            pass
        except Exception as exc:  # noqa: BLE001 - re-raised on the consumer
            ready_q.put(("error", exc))

    filler = threading.Thread(target=fill, daemon=True, name="oim-plane-fill")
    filler.start()
    try:
        while True:
            item = _q_get(ready_q, stop)
            if item[0] == "done":
                return
            if item[0] == "error":
                raise item[1]
            _, buf, used, view_off = item
            try:
                yield view_off, buf[:used]
            finally:
                free_q.put(buf)
    finally:
        stop.set()
        filler.join(timeout=30)


# ------------------------------------------------------------- device land --

# Device bytes of the most recent stage_source call as the pipeline
# accounts them: the preallocated destination (chunks land in place, so
# nothing transient rides on the device).
LAST_STAGE_PEAK = 0
# Wall-second breakdown of the most recent stage_source call: disk_s
# (source reads on the filler thread), h2d_s (waits on each chunk's copy
# before its buffer is recycled, and the final copy-stream fence),
# dispatch_s (enqueuing each chunk's copy on the copy stream).
LAST_STAGE_BREAKDOWN: dict = {}
# Total stage_source invocations: tests and the chip smoke read it to show
# that the plane (not the whole-read fallback, not the cache) served a
# stage.
STAGE_CALLS = 0
# stage_source runs on backend staging threads: concurrent stages must not
# interleave the read-modify-write of the statistics above.
_STATS_LOCK = threading.Lock()


def _device_empty(nbytes: int, device: torch.device) -> torch.Tensor:
    """The destination, allocated on the device's current stream (the
    default stream, which the staging thread shares with the trainer).

    The caching allocator ties a block to the stream it was allocated on,
    which guards both directions of reuse: allocated here, the block is
    never handed out again while consumers on the default stream still
    read the staged volume (as it would be if allocated on the copy
    stream); and since the block may have just been freed by kernels
    still queued on the default stream, ``_stage_view`` makes the copy
    stream wait on that stream before its first copy."""
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


class _StageControl:
    """State of one stage_source call: progress, the device-byte peak and
    the wall-time breakdown (the filler thread adds its read time, hence
    the lock)."""

    def __init__(self, progress):
        self._progress = progress
        self._lock = threading.Lock()
        self.peak = 0  # preallocated device bytes
        self.disk_s = 0.0
        self.h2d_s = 0.0
        self.dispatch_s = 0.0

    def add_disk(self, seconds: float) -> None:
        with self._lock:
            self.disk_s += seconds

    def add_h2d(self, seconds: float) -> None:
        with self._lock:
            self.h2d_s += seconds

    def add_dispatch(self, seconds: float) -> None:
        with self._lock:
            self.dispatch_s += seconds

    def breakdown(self) -> dict:
        return {"disk_s": self.disk_s, "h2d_s": self.h2d_s,
                "dispatch_s": self.dispatch_s}

    def report(self, landed: int) -> bool:
        """Call the progress callback with the bytes landed so far.
        Returns False when staging must abort."""
        return self._progress is None or self._progress(landed) is not False


def _stage_view(src, runs, device, chunk_bytes, ctl):
    """Stage one view (run list) onto ``device``; returns the uint8
    destination, or None on abort (the destination dropped).

    On a CUDA device the reader fills page-locked buffers and each chunk
    is copied from its buffer, on a dedicated copy stream, into its slice
    of the destination. The buffer goes back to the reader at the next
    iteration, so the loop waits on the copy's event first; the reader
    meanwhile fills the other buffers. On a CPU device the chunk is copied
    into the destination before the loop goes on, so nothing aliases the
    reader's recycled buffer."""
    total = sum(n for _, n in runs)
    buf = _device_empty(total, device)
    ctl.peak = total
    on_cuda = device.type == "cuda"
    copy_stream = fence = None
    if on_cuda:
        copy_stream = torch.cuda.Stream(device)
        # The block may come from memory that kernels queued on the
        # current stream still use (see _device_empty).
        copy_stream.wait_stream(torch.cuda.current_stream(device))
        fence = torch.cuda.Event()

    def drain():
        """Every enqueued copy must have read its buffer (and written the
        destination) before either is released."""
        if copy_stream is not None:
            copy_stream.synchronize()

    chunks = iter_view_chunks(src, runs, chunk_bytes,
                              on_read_seconds=ctl.add_disk, pin=on_cuda)
    try:
        for view_off, chunk in chunks:
            n = chunk.size
            dst = buf[view_off:view_off + n]
            host = torch.from_numpy(chunk)
            t0 = time.monotonic()
            if not on_cuda:
                dst.copy_(host)
                ctl.add_h2d(time.monotonic() - t0)
            else:
                if not host.is_pinned():
                    # copy_(non_blocking=True) from pageable memory runs
                    # synchronously and says nothing about it.
                    raise RuntimeError("staging buffer is not page-locked")
                with torch.cuda.stream(copy_stream):
                    dst.copy_(host, non_blocking=True)
                    fence.record(copy_stream)
                ctl.add_dispatch(time.monotonic() - t0)
                t0 = time.monotonic()
                fence.synchronize()
                ctl.add_h2d(time.monotonic() - t0)
            if not ctl.report(view_off + n):
                drain()
                return None
        t0 = time.monotonic()
        drain()
        ctl.add_h2d(time.monotonic() - t0)
    except BaseException:
        drain()
        # The traceback keeps this frame alive: let go of the destination
        # here, or the device memory stays held until the error is dropped.
        buf = dst = None  # noqa: F841
        raise
    finally:
        chunks.close()
    return buf


def _as_typed(buf: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    out = buf if dtype == torch.uint8 else buf.view(dtype)  # zero-copy
    return out.reshape(shape)


def placement_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes the single-device placement stages: the whole array."""
    return math.prod(int(d) for d in shape) * dtype.itemsize


def stage_source(
    src: ExtentSource,
    *,
    dtype: torch.dtype,
    shape: tuple[int, ...],
    device,
    chunk_bytes: int = 64 << 20,
    progress=None,
) -> torch.Tensor | None:
    """Stage an extent source into a tensor of ``dtype`` and ``shape`` on
    ``device``, the source's bytes unchanged.

    ``progress(bytes_landed)`` returning False aborts (the partial
    destination dropped, returns None): the unstage-during-staging hook.
    """
    global LAST_STAGE_PEAK, LAST_STAGE_BREAKDOWN, STAGE_CALLS

    with _STATS_LOCK:
        STAGE_CALLS += 1
    device = torch.device(device)
    shape = tuple(int(d) for d in shape)
    runs = [(0, placement_bytes(shape, dtype))]
    ctl = _StageControl(progress)
    try:
        if device.type == "cuda":
            # A new thread starts on device 0: make the target current.
            with torch.cuda.device(device):
                buf = _stage_view(src, runs, device, chunk_bytes, ctl)
        else:
            buf = _stage_view(src, runs, device, chunk_bytes, ctl)
    finally:
        with _STATS_LOCK:
            LAST_STAGE_PEAK = ctl.peak
            LAST_STAGE_BREAKDOWN = ctl.breakdown()
    if buf is None:
        return None  # cancelled via progress
    return _as_typed(buf, dtype, shape)
