"""The uniform data plane (``oim_tpu/data/plane.py``): sources lower to
byte extents, a placement lowers to byte runs, and one chunked
read-ahead -> host-to-device pipeline lands the runs in device tensors.

- **Sources lower to extents** (``lower_source``): byte ranges of local
  files ("file") or of HTTP objects ("object", read by ranged GETs). A
  raw file is one extent; a TFRecord path list or a multi-shard
  webdataset (local paths or http(s) URLs) is one extent per file or
  object laid back to back (framing and tar bytes stay intact); a ceph
  image is one object behind its gateway; .npy is its payload extent
  with dtype/shape lifted from the header.
- **Placements lower to runs** (``slice_runs``): a ``Placement`` (the
  port's stand-in for a ``NamedSharding``: a mesh's axes, the axes that
  split each array dim, and the devices this process holds with their
  mesh coordinates) gives each addressable device its per-dim slices
  (``addressable_indices_map``), and each slice is the byte runs of the
  row-major volume whose concatenation is the slice's buffer. A placement
  over a port ``Mesh`` holds one device, this rank's: each rank of a
  trainer reads and lands its own slice only, as a JAX host does in a
  multi-process mesh. A placement over a ``LocalMesh`` (devices laid out
  row-major over the axes, as a JAX process holds its local mesh) holds
  every device of a controller that owns several cards. A slice that
  would explode into more than ``MAX_RUNS`` runs raises
  ``PlacementNotLowerable`` before any device memory is taken, and the
  backend falls back to the whole-read path.
- **One pipeline, concurrent groups.** ``stage_source`` groups the
  devices that hold identical slices (each distinct slice is read once
  and lands on every holder) and stages the groups on a thread pool of
  ``max_workers``. In each group ``iter_view_chunks`` streams the view
  through a pool of page-locked host buffers filled by a read-ahead
  thread, and ``_stage_view`` copies each chunk from its buffer, on a
  dedicated copy stream per device, straight into its slice of the
  preallocated destination: ``buf[off:off + n].copy_(chunk,
  non_blocking=True)``. Device peak is the destinations themselves; the
  JAX package's donated ``dynamic_update_slice`` needed a chunk more and
  a padded tail so that one compiled program served every chunk. The JAX
  package also copies each chunk into a second pinned transfer slot
  first; on the H100 host that extra copy ran beside the reads and made
  the stage slower (PERF.md), so the port copies from the reader's
  buffer.

The staged result of a sharded placement is a ``Placed``: the global shape
and dtype, the placement, and each addressable shard as (coordinate,
device, tensor), in place of a global ``jax.Array``. A single-device
placement returns the plain tensor, as JAX returns the lone shard.

Fences are CUDA events: one is recorded on the copy stream after each
chunk's copy and synchronised before the reader gets the buffer back, and
the copy stream is synchronised before ``stage_source`` returns, so a
staged tensor holds its bytes on the device when the caller sees it. The
copy stream first waits on the device's current stream, so no copy lands
in a recycled block that earlier work (a training step) still uses.

A tensor has no ``delete()``: on abort or error the stager drops its last
reference to each destination, and the caching allocator takes the memory
back.
"""
from __future__ import annotations

import bisect
import concurrent.futures
import dataclasses
import itertools
import math
import os
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from oim_tpu_torch.data import objectstore, staging


@dataclasses.dataclass(frozen=True)
class Extent:
    """``length`` bytes at ``offset`` inside a local file ("file") or a
    ranged-read HTTP object ("object"). Tests may register extra kinds in
    ``READERS`` (e.g. throttled readers).

    ``object_size``, set at lowering from Content-Length, lets the ranged
    reads find an object that changed between sizing and staging."""

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
    headers: dict[str, str] | None = None  # object-store auth
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


def _read_object_extent(locator, offset, length, dst, headers, object_size=None):
    objectstore.read_range(locator, offset, length, dst[:length], headers,
                           expected_total=object_size)


READERS["file"] = _read_file_extent
READERS["object"] = _read_object_extent


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
        kwargs = {}
        if ext.object_size is not None:
            kwargs["object_size"] = ext.object_size
        READERS[ext.kind](ext.locator, ext.offset + inner, n,
                          dst[filled:filled + n], src.headers, **kwargs)
        filled += n
        i += 1


# --------------------------------------------------------- source lowering --


def _file_extent(path: str) -> Extent:
    return Extent("file", str(path), 0, os.path.getsize(path))


def _object_extent(url: str, headers=None) -> Extent:
    size = objectstore.content_length(url, headers)
    return Extent("object", url, 0, size, object_size=size)


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


def lower_source(params_kind: str, params) -> ExtentSource | None:
    """MapVolume params -> ExtentSource, or None when the source is not
    extent-lowerable (malloc host buffers, exotic formats) and the caller
    must keep the whole-read path. Runs on the staging thread: sizing I/O
    (stat, HEAD) and a missing file or object surface through the
    volume's status, never at ``stage``."""
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
        return ExtentSource([
            _object_extent(u) if objectstore.is_url(u) else _file_extent(u)
            for u in params.shard_urls
        ])
    if params_kind == "ceph":
        url, headers = objectstore.ceph_object(params)
        return ExtentSource([_object_extent(url, headers)], headers=headers or None)
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


# ------------------------------------------------------- placement lowering --

# A slice whose leading dims explode into more runs than this falls back
# to whole-array staging (each run is a separate pread/range-GET; millions
# of tiny runs would defeat the read-ahead).
MAX_RUNS = 65536


def slice_runs(
    shape: tuple[int, ...], index: tuple, itemsize: int
) -> tuple[list[tuple[int, int]], tuple[int, ...]] | None:
    """(byte runs, slice shape) of ``index`` (a per-dim slice tuple from
    ``Placement.addressable_indices_map``) inside the row-major global
    array; runs are emitted in the slice's own row-major order so their
    concatenation IS the slice's buffer. None when the layout would
    exceed MAX_RUNS."""
    dims = len(shape)
    starts, stops = [], []
    for d in range(dims):
        s = index[d] if d < len(index) else slice(None)
        if s.step not in (None, 1):
            # A stepped slice would need per-element runs; staging the
            # contiguous [start, stop) range instead would land WRONG
            # bytes silently — fall back to whole-array staging.
            return None
        starts.append(int(s.start) if s.start is not None else 0)
        stops.append(int(s.stop) if s.stop is not None else int(shape[d]))
    slice_shape = tuple(stops[d] - starts[d] for d in range(dims))
    # Trailing dims fully covered merge into one contiguous run.
    t = dims
    while t > 0 and starts[t - 1] == 0 and stops[t - 1] == shape[t - 1]:
        t -= 1
    strides = [1] * dims  # element strides, row-major
    for d in range(dims - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    if t == 0:
        total = int(np.prod(shape, dtype=np.int64)) if dims else 1
        return [(0, total * itemsize)], slice_shape
    run_elems = (stops[t - 1] - starts[t - 1]) * strides[t - 1]
    outer = [range(starts[d], stops[d]) for d in range(t - 1)]
    n_runs = 1
    for r in outer:
        n_runs *= len(r)
    if n_runs > MAX_RUNS:
        return None
    runs = []
    base0 = starts[t - 1] * strides[t - 1]
    for coords in itertools.product(*outer):
        base = base0 + sum(c * strides[d] for d, c in enumerate(coords))
        runs.append((base * itemsize, run_elems * itemsize))
    return runs, slice_shape


class PlacementNotLowerable(ValueError):
    """The placement's slices exceed MAX_RUNS runs; callers fall back to
    whole-array staging."""


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Devices one process holds, laid out row-major over named axes (as a
    JAX process holds its local mesh): a controller that owns several
    cards, or eight "cpu" devices standing in for them."""

    axes: tuple[tuple[str, int], ...]
    devices: tuple[torch.device, ...]

    def __init__(self, axes, devices):
        axes = tuple((str(n), int(s)) for n, s in axes)
        devices = tuple(torch.device(d) for d in devices)
        if math.prod(s for _, s in axes) != len(devices):
            raise ValueError(f"mesh axes {list(axes)} need "
                             f"{math.prod(s for _, s in axes)} devices, got {len(devices)}")
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "devices", devices)


def _dims_of(spec) -> tuple[tuple[str, ...], ...]:
    """Per-dim mesh axes of a spec: an ``ArraySpec.sharding_axes`` list
    ("" whole) or PartitionSpec-like entries (None, a name, or a tuple)."""
    out = []
    for e in spec:
        if not e:
            out.append(())
        elif isinstance(e, (tuple, list)):
            out.append(tuple(str(a) for a in e))
        else:
            out.append((str(e),))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each slice of an array lives: the port's ``NamedSharding``.

    ``axes`` are the mesh's (name, size) in order, ``dims`` the mesh axes
    splitting each array dim (outer first, as a PartitionSpec entry lists
    them), ``shards`` the addressable (mesh coordinate, device) pairs in
    row-major mesh order, and ``mesh_id`` names the mesh for cache keys
    and equality: its ranks (a port ``Mesh``) or its devices (a
    ``LocalMesh``)."""

    axes: tuple[tuple[str, int], ...]
    dims: tuple[tuple[str, ...], ...]
    shards: tuple[tuple[tuple[int, ...], torch.device], ...]
    mesh_id: tuple

    @classmethod
    def of(cls, mesh, spec) -> "Placement":
        """The placement of ``spec`` (see ``_dims_of``) over ``mesh``: a port
        ``Mesh`` (this rank's device alone) or a ``LocalMesh`` (each of its
        devices). Raises ValueError, as a NamedSharding does, for an axis
        the mesh lacks or one used twice."""
        if isinstance(mesh, LocalMesh):
            axes = mesh.axes
            coords = itertools.product(*(range(s) for _, s in axes))
            shards = tuple(zip(coords, mesh.devices))
            mesh_id = ("devices", tuple(str(d) for d in mesh.devices))
        else:  # parallel.mesh.Mesh: this rank's view
            if mesh.coordinate is None:
                raise ValueError(f"this rank lies outside the mesh {mesh}")
            axes = tuple((n, int(mesh.shape[n])) for n in mesh.axis_names)
            shards = ((tuple(mesh.coordinate), mesh.device),)
            mesh_id = ("ranks", tuple(mesh.ranks))
        dims = _dims_of(spec)
        names = [n for n, _ in axes]
        seen: set[str] = set()
        for d in dims:
            for name in d:
                if name not in names:
                    raise ValueError(f"Resource axis: {name} of {list(spec)} is not found "
                                     f"in mesh: {tuple(names)}.")
                if name in seen:
                    raise ValueError(f"A mesh axis may appear once in a spec: {list(spec)}")
                seen.add(name)
        return cls(axes, dims, shards, mesh_id)

    def parts(self, coord: tuple[int, ...], dim: int) -> tuple[int, int]:
        """(pieces, the piece at ``coord``) along array dim ``dim``."""
        names = [n for n, _ in self.axes]
        n, idx = 1, 0
        if dim < len(self.dims):
            for name in self.dims[dim]:
                a = names.index(name)
                n, idx = n * self.axes[a][1], idx * self.axes[a][1] + coord[a]
        return n, idx

    def addressable_indices_map(self, shape) -> dict[tuple[int, ...], tuple]:
        """Each addressable coordinate's per-dim slices of an array of
        ``shape``, as ``addressable_devices_indices_map`` gives them (a
        whole dim is ``slice(None)``); ValueError where a split does not
        divide its dim, as JAX's."""
        shape = tuple(int(d) for d in shape)
        out = {}
        for coord, _ in self.shards:
            index = []
            for dim, size in enumerate(shape):
                n, i = self.parts(coord, dim)
                if n == 1:
                    index.append(slice(None))
                    continue
                if size % n:
                    raise ValueError(
                        f"placement {self.dims} over {dict(self.axes)} implies that array "
                        f"axis {dim} is partitioned {n} times, but the dimension size is "
                        f"{size} (full shape: {shape})")
                step = size // n
                index.append(slice(i * step, (i + 1) * step))
            out[coord] = tuple(index)
        return out


@dataclasses.dataclass
class Placed:
    """An array staged under a sharded ``Placement``: its global shape and
    dtype, and each addressable shard as (coordinate, device, tensor). The
    port's global ``jax.Array``."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    placement: Placement
    shards: list[tuple[tuple[int, ...], torch.device, torch.Tensor]]

    @property
    def local(self) -> torch.Tensor:
        """This rank's tensor (the first addressable shard's)."""
        return self.shards[0][2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for _, _, t in self.shards)

    @property
    def device_index(self) -> int:
        """The lowest index among the shards' devices (0 for the CPU)."""
        return min(d.index or 0 for _, d, _ in self.shards)

    def __getitem__(self, i: int) -> "Placed":
        """Row ``i`` of a leading dim the placement leaves whole (a batch
        of a [n_batches, B, ...] token volume): a view of every shard."""
        if self.placement.dims and self.placement.dims[0]:
            raise IndexError("indexing a leading dim the placement splits")
        placement = dataclasses.replace(self.placement, dims=self.placement.dims[1:])
        return Placed(self.shape[1:], self.dtype, placement,
                      [(c, d, t[i]) for c, d, t in self.shards])

    def assemble(self, device="cpu") -> torch.Tensor:
        """The global array on ``device`` from the addressable shards;
        ValueError where they do not cover it (a rank's view of a mesh)."""
        imap = self.placement.addressable_indices_map(self.shape)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for coord, _, t in self.shards:
            key = tuple((s.start, s.stop) for s in imap[coord])
            if key not in seen:
                seen.add(key)
                out[imap[coord]] = t.to(device)
        pieces = math.prod(self.placement.parts(self.shards[0][0], d)[0]
                           for d in range(len(self.shape))) if self.shards else 1
        if len(seen) < pieces:
            raise ValueError(f"{len(seen)} addressable slices of {pieces} do not cover "
                             f"the array")
        return out

    def delete(self) -> None:
        """Drop every shard's tensor (its memory goes once no one else
        holds it)."""
        self.shards = []


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
# accounts them: the preallocated destinations. Chunks land in place, so
# no group holds device bytes beyond its destinations (the JAX package's
# model adds two chunks a group for its donated update).
LAST_STAGE_PEAK = 0
# Most shard groups staging at once in the most recent stage_source call:
# the concurrency the pool reached.
LAST_STAGE_CONCURRENCY = 0
# Wall-second breakdown of the most recent stage_source call, summed over
# its groups: disk_s (source reads on the filler threads), h2d_s (waits on
# each chunk's copies before its buffer is recycled, and the final
# copy-stream fences), dispatch_s (enqueuing each chunk's copies).
LAST_STAGE_BREAKDOWN: dict = {}
# Total stage_source invocations: tests and the chip smoke read it to show
# that the plane (not the whole-read fallback, not the cache) served a
# stage.
STAGE_CALLS = 0
# stage_source runs on backend staging threads: concurrent stages must not
# interleave the read-modify-write of the statistics above.
_STATS_LOCK = threading.Lock()


def _default_workers() -> int:
    """Width of the shard-group pool: ``$OIM_STAGE_WORKERS`` or 4. Each
    group in flight holds its own read-ahead buffers and copy streams."""
    try:
        return max(1, int(os.environ.get("OIM_STAGE_WORKERS", "4")))
    except ValueError:
        return 4


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
    """Shared, thread-safe state of one stage_source call: cumulative
    progress across concurrently staging groups, cooperative abort, the
    device-byte peak, the most groups in flight and the wall-time
    breakdown."""

    def __init__(self, progress):
        self._progress = progress
        self.abort = threading.Event()
        self._lock = threading.Lock()
        self._landed: dict[int, int] = {}  # group -> bytes landed
        self.peak = 0  # preallocated destinations
        self._inflight = 0
        self.max_inflight = 0
        self.disk_s = 0.0
        self.h2d_s = 0.0
        self.dispatch_s = 0.0

    # -- group lifecycle ---------------------------------------------------

    def group_started(self) -> None:
        with self._lock:
            self._inflight += 1
            self.max_inflight = max(self.max_inflight, self._inflight)

    def group_finished(self) -> None:
        with self._lock:
            self._inflight -= 1

    # -- accounting --------------------------------------------------------

    def add_live(self, nbytes: int) -> None:
        with self._lock:
            self.peak += nbytes

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

    # -- progress / abort --------------------------------------------------

    def report(self, group: int, landed: int) -> bool:
        """Record the group's landed bytes and call the progress callback
        with the total over the groups, under the lock, so totals reach it
        in order. Returns False when staging must abort."""
        if self.abort.is_set():
            return False
        if self._progress is None:
            return True
        with self._lock:
            self._landed[group] = landed
            if self.abort.is_set():
                return False
            ok = self._progress(sum(self._landed.values()))
        if ok is False:
            self.abort.set()
            return False
        return True


def _stage_view(src, runs, devices, chunk_bytes, ctl, group):
    """Stage one view (run list) onto every device of ``devices`` (they
    hold identical slices: the host bytes are read once); returns the uint8
    destinations in order, or None on abort (the destinations dropped).

    On CUDA devices the reader fills page-locked buffers and each chunk is
    copied from its buffer, on a dedicated copy stream of each holder, into
    its slice of the holder's destination. The buffer goes back to the
    reader at the next iteration, so the loop waits on the copies' events
    first; the reader meanwhile fills the other buffers. On the CPU the
    chunk is copied into each destination before the loop goes on, so
    nothing aliases the reader's recycled buffer."""
    total = sum(n for _, n in runs)
    bufs = [_device_empty(total, d) for d in devices]
    ctl.add_live(total * len(devices))
    on_cuda = devices[0].type == "cuda"
    streams, fences = [], []
    if on_cuda:
        for d in devices:
            with torch.cuda.device(d):
                s = torch.cuda.Stream(d)
                # The block may come from memory that kernels queued on
                # the current stream still use (see _device_empty).
                s.wait_stream(torch.cuda.current_stream(d))
                streams.append(s)
                fences.append(torch.cuda.Event())

    def drain():
        """Every enqueued copy must have read its buffer (and written the
        destination) before either is released."""
        for s in streams:
            s.synchronize()

    chunks = iter_view_chunks(src, runs, chunk_bytes,
                              on_read_seconds=ctl.add_disk, pin=on_cuda)
    try:
        for view_off, chunk in chunks:
            if ctl.abort.is_set():
                drain()
                return None
            n = chunk.size
            host = torch.from_numpy(chunk)
            t0 = time.monotonic()
            if not on_cuda:
                for buf in bufs:
                    buf[view_off:view_off + n].copy_(host)
                ctl.add_h2d(time.monotonic() - t0)
            else:
                if not host.is_pinned():
                    # copy_(non_blocking=True) from pageable memory runs
                    # synchronously and says nothing about it.
                    raise RuntimeError("staging buffer is not page-locked")
                for buf, s, fence in zip(bufs, streams, fences):
                    with torch.cuda.stream(s):
                        buf[view_off:view_off + n].copy_(host, non_blocking=True)
                        fence.record(s)
                ctl.add_dispatch(time.monotonic() - t0)
                t0 = time.monotonic()
                for fence in fences:
                    fence.synchronize()
                ctl.add_h2d(time.monotonic() - t0)
            if not ctl.report(group, (view_off + n) * len(devices)):
                drain()
                return None
        t0 = time.monotonic()
        drain()
        ctl.add_h2d(time.monotonic() - t0)
    except BaseException:
        drain()
        # The traceback keeps this frame alive: let go of the destinations
        # here, or the device memory stays held until the error is dropped.
        bufs = host = None  # noqa: F841
        raise
    finally:
        chunks.close()
    return bufs


def _as_typed(buf: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    out = buf if dtype == torch.uint8 else buf.view(dtype)  # zero-copy
    return out.reshape(shape)


def placement_bytes(shape, dtype: torch.dtype, placement: Placement | None = None) -> int:
    """Physical bytes the placement stages: the sum of the addressable
    slices (a replicated dim counts once per holder); the whole array for
    one device (``placement`` None) or a slice past MAX_RUNS."""
    shape = tuple(int(d) for d in shape)
    whole = math.prod(shape) * dtype.itemsize
    if placement is None:
        return whole
    total = 0
    for index in placement.addressable_indices_map(shape).values():
        r = slice_runs(shape, index, dtype.itemsize)
        if r is None:
            return whole
        total += sum(n for _, n in r[0])
    return total


def place_host(host: torch.Tensor, placement: Placement) -> Placed:
    """Each addressable slice of the host array ``host`` copied to its
    device (``jax.device_put(host, sharding)``): the whole-read path of a
    sharded placement."""
    shards = []
    imap = placement.addressable_indices_map(host.shape)
    for coord, device in placement.shards:
        shards.append((coord, device, host[imap[coord]].to(device, copy=True).contiguous()))
    for _, device, _ in shards:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return Placed(tuple(host.shape), host.dtype, placement, shards)


def stage_source(
    src: ExtentSource,
    *,
    dtype: torch.dtype,
    shape: tuple[int, ...],
    device=None,
    placement: Placement | None = None,
    chunk_bytes: int = 64 << 20,
    progress=None,
    max_workers: int | None = None,
) -> torch.Tensor | Placed | None:
    """Stage an extent source into ``dtype`` and ``shape``, the source's
    bytes unchanged: one tensor on ``device``, or, under a ``placement``
    (sharded, replicated or both), a ``Placed`` of each addressable slice.

    Distinct slices stage concurrently on a thread pool of ``max_workers``
    (default ``$OIM_STAGE_WORKERS`` or 4; 1 is the serial path), each group
    with its own read-ahead and copy streams; the bytes are the serial
    path's, since the groups land in disjoint destinations.

    ``progress(bytes_landed)`` returning False aborts (every group's
    destinations dropped, returns None): the unstage-during-staging hook.
    Raises PlacementNotLowerable, before any device memory is taken, when
    a slice exceeds MAX_RUNS runs (the caller falls back to the whole-read
    path).
    """
    global LAST_STAGE_PEAK, LAST_STAGE_CONCURRENCY, LAST_STAGE_BREAKDOWN, STAGE_CALLS

    with _STATS_LOCK:
        STAGE_CALLS += 1
    shape = tuple(int(d) for d in shape)
    single = placement is None
    if single:
        device = torch.device(device)
        placement = Placement((), (), (((), device),), ("device",))
    imap = placement.addressable_indices_map(shape)
    # Group the holders of identical slices: each distinct slice is read
    # once and lands on every holder.
    groups: dict[tuple, tuple[list, tuple]] = {}
    for coord, dev in placement.shards:
        index = imap[coord]
        key = tuple((s.start or 0, -1 if s.stop is None else s.stop) for s in index)
        groups.setdefault(key, ([], index))[0].append((coord, dev))
    # Lower every slice BEFORE allocating device memory: a run explosion
    # in any group must fall back with nothing staged.
    lowered = []
    for holders, index in groups.values():
        lr = slice_runs(shape, index, dtype.itemsize)
        if lr is None:
            raise PlacementNotLowerable(
                f"placement of {shape} over {placement.dims} exceeds {MAX_RUNS} runs per "
                "slice")
        lowered.append((holders, lr[0], lr[1]))
    ctl = _StageControl(progress)
    n_workers = max(1, min(len(lowered), max_workers or _default_workers()))
    results: list[list | None] = [None] * len(lowered)
    errors: list[BaseException] = []

    def run_group(i: int) -> None:
        holders, runs, _ = lowered[i]
        devices = [d for _, d in holders]
        ctl.group_started()
        try:
            if devices[0].type == "cuda":
                # A new thread starts on device 0: make the target current.
                with torch.cuda.device(devices[0]):
                    results[i] = _stage_view(src, runs, devices, chunk_bytes, ctl, i)
            else:
                results[i] = _stage_view(src, runs, devices, chunk_bytes, ctl, i)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            with ctl._lock:
                errors.append(exc)
            ctl.abort.set()
        finally:
            ctl.group_finished()

    try:
        if n_workers == 1:
            for i in range(len(lowered)):
                if ctl.abort.is_set():
                    break
                run_group(i)
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    n_workers, thread_name_prefix="oim-stage") as pool:
                concurrent.futures.wait([pool.submit(run_group, i)
                                         for i in range(len(lowered))])
    finally:
        with _STATS_LOCK:
            LAST_STAGE_PEAK = ctl.peak
            LAST_STAGE_CONCURRENCY = ctl.max_inflight
            LAST_STAGE_BREAKDOWN = ctl.breakdown()
    if errors or ctl.abort.is_set():
        results.clear()  # every group's destinations go with the last reference
        if errors:
            raise errors[0]
        return None  # cancelled via progress
    shards = []
    for (holders, _, slice_shape), bufs in zip(lowered, results):
        for (coord, dev), buf in zip(holders, bufs):
            shards.append((coord, dev, _as_typed(buf, dtype, slice_shape)))
    if single:
        return shards[0][2]
    order = {coord: i for i, (coord, _) in enumerate(placement.shards)}
    shards.sort(key=lambda s: order[s[0]])
    return Placed(shape, dtype, placement, shards)
