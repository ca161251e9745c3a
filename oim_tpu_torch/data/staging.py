"""Host half of the staging engine (``oim_tpu/data/staging.py``): pinned
host buffers and file reads into them, by one of three engines.

- **native**: the C++ engine of ``native/staging.cc`` (parallel ``pread``
  threads, ``oim_read_into``; a read-ahead stream, ``oim_stream_*``).
  ``build()`` compiles that source, read in place, with ``g++`` into
  ``data/build/`` inside the checkout (listed in ``.gitignore``); the file
  name carries a hash of the source and the flags. ``native_lib()`` loads
  only that file, never ``native/libstaging.so``, and never compiles: a
  stage must not wait on a compiler, so callers that want the engine call
  ``build()`` first.
- **io_uring**: a raw-syscall io_uring ring (no liburing), QD large READs
  in flight. Probed once per process; a refused ``io_uring_setup``
  (seccomp, old kernels) or ``OIM_IO_URING=0`` turns it off.
- **preadv**: the destination cut into ranges that a pool of threads
  fills with ``os.preadv``, which releases the interpreter lock. It takes
  the place of the JAX package's single-threaded ``readinto`` loop.

``read_into`` takes the first of them that is there, in that order, and
``read_path()`` names the one that ran. All three are byte-identical.
Every read adds its bytes to ``oim_staged_bytes_total`` and sets
``oim_stage_gbps`` to its rate (``stream``: the C++ stream's rate), the
disk half of a stage apart from its host-to-device half. The JAX package
leaves the gauge alone on its plain ``readinto`` fallback; ``preadv``,
which takes that fallback's place here, is a parallel engine and sets it.

Page-locked buffers stay torch's (``alloc_pinned``). ``oim_pinned_alloc``
is ``malloc`` + ``mlock``, which CUDA does not know as pinned: a
``non_blocking`` copy from it would be staged and synchronous. The native
engine reads into torch's buffers through their addresses.

``decode_jpeg_batch`` binds the engine's JPEG batch decoder, which only a
build that found ``<jpeglib.h>`` holds; without it the image feeds decode
with Pillow. ``stage_file_to_device`` stages a file onto one device
through ``data/plane.py``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import errno as errno_mod
import hashlib
import mmap
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from oim_tpu_torch.common import metrics as M

# Each thread of a parallel preadv read takes at least this many bytes;
# smaller reads run on the calling thread.
_MIN_THREAD_BYTES = 4 << 20

ENGINES = ("native", "io_uring", "preadv")

_NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "staging.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib = None  # None: not tried; False: not built or refused
_lock = threading.Lock()


class StagingError(IOError):
    pass


# -- the native engine --------------------------------------------------------


def _bind(lib) -> None:
    lib.oim_staging_abi_version.restype = ctypes.c_int
    lib.oim_read_into.restype = ctypes.c_int64
    lib.oim_read_into.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.oim_file_size.restype = ctypes.c_int64
    lib.oim_file_size.argtypes = [ctypes.c_char_p]
    lib.oim_last_error.restype = ctypes.c_char_p
    lib.oim_pinned_alloc.restype = ctypes.c_void_p
    lib.oim_pinned_alloc.argtypes = [ctypes.c_size_t]
    lib.oim_pinned_free.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.oim_stream_open.restype = ctypes.c_void_p
    lib.oim_stream_open.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
    ]
    lib.oim_stream_next.restype = ctypes.c_int64
    lib.oim_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.oim_stream_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.oim_stream_gbps.restype = ctypes.c_double
    lib.oim_stream_gbps.argtypes = [ctypes.c_void_p]
    lib.oim_stream_file_size.restype = ctypes.c_int64
    lib.oim_stream_file_size.argtypes = [ctypes.c_void_p]
    lib.oim_stream_close.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "oim_decode_jpeg_batch"):  # only in a -jpeg build
        lib.oim_decode_jpeg_batch.restype = ctypes.c_int64
        lib.oim_decode_jpeg_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]


def compiler() -> str:
    """The C++ compiler the build runs: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX", "g++")


def has_jpeg() -> bool:
    """Whether ``<jpeglib.h>`` preprocesses (``native/Makefile``'s test):
    ``staging.cc`` then compiles its JPEG decoder in, and the build links
    ``-ljpeg``."""
    try:
        probe = subprocess.run(
            [compiler(), *CXX_FLAGS, "-E", "-x", "c++", "-"],
            input=b"#include <jpeglib.h>\n", capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return probe.returncode == 0


def _build_cmd(out: Path, jpeg: bool) -> list[str]:
    return [compiler(), *CXX_FLAGS, "-o", str(out), str(_NATIVE_SRC),
            *(["-ljpeg"] if jpeg else [])]


def lib_path(jpeg: bool) -> Path:
    """Where the engine built from the current source and flags, with or
    without the JPEG decoder, lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libstaging-{h.hexdigest()[:16]}{'-jpeg' if jpeg else ''}.so"


def build() -> Path:
    """Compile ``native/staging.cc`` unless the file for this source and
    these flags is there; returns its path. Writes a temporary name and
    renames it into place, so concurrent builders (test workers) never
    load a half-written library. Raises with the compiler's output on a
    failed build."""
    global _lib
    jpeg = has_jpeg()
    target = lib_path(jpeg)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            done = subprocess.run(_build_cmd(tmp, jpeg), capture_output=True, text=True,
                                  timeout=300)
            if done.returncode != 0:
                raise StagingError(f"native build failed (exit {done.returncode}):\n"
                                   f"{done.stdout}{done.stderr}")
            os.replace(tmp, target)
        finally:
            tmp.unlink(missing_ok=True)
    with _lock:
        if _lib is False:
            _lib = None  # a miss cached before the build: look again
    return target


def native_lib():
    """The loaded engine, or None when it is not built (or its ABI is not
    version 1). Never compiles."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = False
            for path in (lib_path(True), lib_path(False)):
                if not path.exists():
                    continue
                try:
                    lib = ctypes.CDLL(str(path))
                    _bind(lib)
                    if lib.oim_staging_abi_version() == 1:
                        _lib = lib
                except OSError:
                    pass
                break
        return _lib or None


def has_native() -> bool:
    return native_lib() is not None


def _raise_last(lib, context: str) -> None:
    err = lib.oim_last_error().decode() or "unknown error"
    raise StagingError(f"{context}: {err}")


# -- the io_uring ring ----------------------------------------------------------

_SYS_IO_URING_SETUP = 425
_SYS_IO_URING_ENTER = 426
_IORING_OFF_SQ_RING = 0
_IORING_OFF_CQ_RING = 0x8000000
_IORING_OFF_SQES = 0x10000000
_IORING_OP_READ = 22
_IORING_ENTER_GETEVENTS = 1
_IORING_FEAT_SINGLE_MMAP = 1


class _SqOffsets(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "head", "tail", "ring_mask", "ring_entries", "flags", "dropped",
        "array", "resv1")] + [("resv2", ctypes.c_uint64)]


class _CqOffsets(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "head", "tail", "ring_mask", "ring_entries", "overflow", "cqes",
        "flags", "resv1")] + [("resv2", ctypes.c_uint64)]


class _IoUringParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "sq_entries", "cq_entries", "flags", "sq_thread_cpu",
        "sq_thread_idle", "features", "wq_fd")] + [
        ("resv", ctypes.c_uint32 * 3),
        ("sq_off", _SqOffsets), ("cq_off", _CqOffsets)]


class _Sqe(ctypes.Structure):
    _fields_ = [
        ("opcode", ctypes.c_uint8), ("flags", ctypes.c_uint8),
        ("ioprio", ctypes.c_uint16), ("fd", ctypes.c_int32),
        ("off", ctypes.c_uint64), ("addr", ctypes.c_uint64),
        ("len", ctypes.c_uint32), ("rw_flags", ctypes.c_uint32),
        ("user_data", ctypes.c_uint64), ("buf_index", ctypes.c_uint16),
        ("personality", ctypes.c_uint16),
        ("splice_fd_in", ctypes.c_int32), ("pad2", ctypes.c_uint64 * 2)]


class _Cqe(ctypes.Structure):
    _fields_ = [("user_data", ctypes.c_uint64), ("res", ctypes.c_int32),
                ("flags", ctypes.c_uint32)]


class _IoUring:
    """One io_uring instance: QD large READ ops in flight, the ring's
    bookkeeping in Python (the io_uring_enter syscall is the memory
    barrier between these plain tail/head stores and the kernel's)."""

    QD = 32
    CHUNK = 4 << 20

    def __init__(self) -> None:
        libc = ctypes.CDLL(None, use_errno=True)
        self._syscall = libc.syscall
        self._syscall.restype = ctypes.c_long
        p = _IoUringParams()
        fd = self._syscall(ctypes.c_long(_SYS_IO_URING_SETUP),
                           ctypes.c_uint(self.QD), ctypes.byref(p))
        if fd < 0:
            raise OSError(ctypes.get_errno(), "io_uring_setup failed")
        self.ring_fd = int(fd)
        try:
            sq_size = p.sq_off.array + p.sq_entries * 4
            cq_size = p.cq_off.cqes + p.cq_entries * ctypes.sizeof(_Cqe)
            single = bool(p.features & _IORING_FEAT_SINGLE_MMAP)
            if single:
                sq_size = cq_size = max(sq_size, cq_size)
            self._sq_mm = mmap.mmap(self.ring_fd, sq_size, offset=_IORING_OFF_SQ_RING)
            self._cq_mm = (self._sq_mm if single else
                           mmap.mmap(self.ring_fd, cq_size, offset=_IORING_OFF_CQ_RING))
            self._sqes_mm = mmap.mmap(self.ring_fd, p.sq_entries * ctypes.sizeof(_Sqe),
                                      offset=_IORING_OFF_SQES)
        except OSError:
            os.close(self.ring_fd)
            raise
        u32 = ctypes.c_uint32
        self._sq_tail = u32.from_buffer(self._sq_mm, p.sq_off.tail)
        self._sq_mask = u32.from_buffer(self._sq_mm, p.sq_off.ring_mask)
        self._sq_array = (u32 * p.sq_entries).from_buffer(self._sq_mm, p.sq_off.array)
        self._cq_head = u32.from_buffer(self._cq_mm, p.cq_off.head)
        self._cq_tail = u32.from_buffer(self._cq_mm, p.cq_off.tail)
        self._cq_mask = u32.from_buffer(self._cq_mm, p.cq_off.ring_mask)
        self._cqes = (_Cqe * p.cq_entries).from_buffer(self._cq_mm, p.cq_off.cqes)
        self._sqes = (_Sqe * p.sq_entries).from_buffer(self._sqes_mm, 0)
        self._lock = threading.Lock()

    def _push(self, fd: int, addr: int, length: int, file_off: int,
              user_data: int) -> None:
        idx = self._sq_tail.value & self._sq_mask.value
        sqe = self._sqes[idx]
        ctypes.memset(ctypes.byref(sqe), 0, ctypes.sizeof(_Sqe))
        sqe.opcode = _IORING_OP_READ
        sqe.fd = fd
        sqe.addr = addr
        sqe.len = length
        sqe.off = file_off
        sqe.user_data = user_data
        self._sq_array[idx] = idx
        self._sq_tail.value = self._sq_tail.value + 1

    def _enter(self, to_submit: int, min_complete: int) -> None:
        ret = self._syscall(
            ctypes.c_long(_SYS_IO_URING_ENTER),
            ctypes.c_uint(self.ring_fd), ctypes.c_uint(to_submit),
            ctypes.c_uint(min_complete),
            ctypes.c_uint(_IORING_ENTER_GETEVENTS), None,
            ctypes.c_size_t(0))
        if ret < 0:
            raise OSError(ctypes.get_errno(), "io_uring_enter failed")

    def read_into(self, path: str, dst: np.ndarray, offset: int) -> int:
        """Fill ``dst`` from ``path`` at ``offset`` with up to QD
        CHUNK-byte READs in flight; returns the bytes read (short at the
        end of the file: the caller judges it). One read at a time per
        ring: one already keeps the queue full."""
        fd = os.open(path, os.O_RDONLY)
        base = dst.ctypes.data
        total = int(dst.size)
        done = 0
        eof = False
        ops: dict[int, tuple[int, int]] = {}  # user_data -> (buffer offset, length)
        next_id = 0
        next_off = 0
        pending = 0  # SQEs pushed since the last io_uring_enter
        try:
            with self._lock:
                while True:
                    while not eof and len(ops) < self.QD and next_off < total:
                        length = min(self.CHUNK, total - next_off)
                        ops[next_id] = (next_off, length)
                        self._push(fd, base + next_off, length, offset + next_off, next_id)
                        next_id += 1
                        next_off += length
                        pending += 1
                    if not ops:
                        break
                    # `pending` counts both the fill above and the
                    # continuations pushed in the drain below: an SQE
                    # pushed and never submitted would make this wait
                    # forever.
                    self._enter(pending, 1)
                    pending = 0
                    while self._cq_head.value != self._cq_tail.value:
                        cqe = self._cqes[self._cq_head.value & self._cq_mask.value]
                        res, ud = int(cqe.res), int(cqe.user_data)
                        self._cq_head.value = self._cq_head.value + 1
                        buf_off, length = ops.pop(ud)
                        if res < 0:
                            raise OSError(-res, f"io_uring read {path}")
                        if res == 0:
                            eof = True
                            continue
                        done += res
                        if res < length:
                            # A short read mid-file (or across the end):
                            # go on from where it stopped; a continuation
                            # at the end completes with res == 0.
                            ops[next_id] = (buf_off + res, length - res)
                            self._push(fd, base + buf_off + res, length - res,
                                       offset + buf_off + res, next_id)
                            next_id += 1
                            pending += 1
            return done
        finally:
            os.close(fd)


_uring: _IoUring | None | bool = None
_uring_error = ""


def io_uring_available() -> bool:
    """Probe (once) whether this process can run the io_uring engine:
    False where ``io_uring_setup`` is refused (seccomp: EPERM; pre-5.6
    kernels) and under ``OIM_IO_URING=0``."""
    global _uring, _uring_error
    with _lock:
        if _uring is None:
            if os.environ.get("OIM_IO_URING", "1") == "0":
                _uring, _uring_error = False, "OIM_IO_URING=0"
            else:
                try:
                    _uring, _uring_error = _IoUring(), ""
                except OSError as err:
                    name = errno_mod.errorcode.get(err.errno or 0, str(err.errno))
                    _uring, _uring_error = False, f"errno {err.errno} ({name})"
        return _uring is not False


def io_uring_error() -> str:
    """Why the io_uring engine is off ("" when it is on)."""
    io_uring_available()
    return _uring_error


# -- reads --------------------------------------------------------------------

_last_read_path = "none"


def read_path() -> str:
    """The engine of the last ``read_into`` in this process: "native",
    "io_uring" or "preadv" ("none" before the first)."""
    return _last_read_path


def alloc_pinned(size: int, pin: bool) -> np.ndarray:
    """A uint8 array of ``size`` bytes: page-locked memory (a pinned torch
    tensor seen as numpy, which keeps the tensor alive) when ``pin``, else
    plain memory. ``pin`` follows the target: True for a CUDA device, False
    for a CPU one, where pinning needs an accelerator and raises."""
    size = max(size, 0)
    if not pin:
        return np.empty(size, dtype=np.uint8)
    return torch.empty(size, dtype=torch.uint8, pin_memory=True).numpy()


def _pread_full(fd: int, dst: np.ndarray, offset: int) -> int:
    """preadv until ``dst`` is full or the file ends; returns bytes read.
    A single call may legally return fewer bytes than asked mid-file."""
    view = memoryview(dst)
    got = 0
    while got < dst.size:
        n = os.preadv(fd, [view[got:]], offset + got)
        if n == 0:
            break
        got += n
    return got


def _preadv_threads(path: str, dst: np.ndarray, offset: int, n_threads: int) -> int:
    total = int(dst.size)
    n = max(1, min(n_threads, total // _MIN_THREAD_BYTES))
    fd = os.open(path, os.O_RDONLY)
    try:
        if n == 1:
            return _pread_full(fd, dst, offset)
        step = -(-total // n)
        ranges = [(a, min(a + step, total)) for a in range(0, total, step)]
        with concurrent.futures.ThreadPoolExecutor(
                len(ranges), thread_name_prefix="oim-pread") as pool:
            futs = [pool.submit(_pread_full, fd, dst[a:b], offset + a) for a, b in ranges]
            return sum(f.result() for f in futs)
    finally:
        os.close(fd)


def _pick_engine(engine: str | None) -> str:
    if engine is None:
        if native_lib() is not None:
            return "native"
        return "io_uring" if io_uring_available() else "preadv"
    if engine not in ENGINES:
        raise ValueError(f"unknown read engine {engine!r}: one of {ENGINES}")
    if engine == "native" and native_lib() is None:
        raise StagingError("the native engine is not built (staging.build())")
    if engine == "io_uring" and not io_uring_available():
        raise StagingError(f"io_uring is unavailable: {io_uring_error()}")
    return engine


def read_into(path: str | os.PathLike, dst: np.ndarray, offset: int = 0,
              n_threads: int = 8, engine: str | None = None) -> None:
    """Fill ``dst`` (uint8, contiguous) from ``path`` starting at byte
    ``offset``; raises StagingError when the file holds fewer bytes.
    ``engine`` None takes the first engine there is (native, io_uring,
    preadv); a named one (timing, tests) raises when it is not there.
    ``n_threads`` is the native and preadv engines' thread count."""
    global _last_read_path
    path = str(path)
    if not dst.flags.c_contiguous or dst.dtype != np.uint8:
        raise ValueError("read_into needs a contiguous uint8 destination")
    engine = _pick_engine(engine)
    _last_read_path = engine
    if not dst.size:
        return
    t0 = time.monotonic()
    if engine == "native":
        lib = native_lib()
        got = lib.oim_read_into(path.encode(), dst.ctypes.data, offset, dst.size, n_threads)
        if got < 0:
            _raise_last(lib, f"read {path}")
    elif engine == "io_uring":
        try:
            got = _uring.read_into(path, dst, offset)
        except OSError as err:
            raise StagingError(f"read {path}: {err}") from err
    else:
        try:
            got = _preadv_threads(path, dst, offset, n_threads)
        except OSError as err:
            raise StagingError(f"read {path}: {err}") from err
    if got != dst.size:
        raise StagingError(f"read {path}: got {got} of {dst.size} bytes")
    M.STAGED_BYTES.inc(dst.size)
    elapsed = time.monotonic() - t0
    if elapsed > 0:
        M.STAGE_GBPS.set(dst.size / elapsed / 1e9)


def read_pinned(path: str | os.PathLike, n_threads: int = 8) -> np.ndarray:
    """Whole file into a uint8 array. The JAX package's buffer is
    page-locked when its C++ engine is built; this one is plain memory:
    its callers (the whole-read staging path) copy it synchronously."""
    arr = alloc_pinned(os.path.getsize(path), pin=False)
    if arr.size:
        read_into(path, arr, n_threads=n_threads)
    return arr


def stream(path: str | os.PathLike, chunk_bytes: int = 64 << 20, n_buffers: int = 3,
           pin: bool = True) -> Iterator[np.ndarray]:
    """Read-ahead chunk iterator over the whole file. With the native
    engine, C++ threads read ahead into ``n_buffers`` buffers (``mlock``ed
    when ``pin``: locked in RAM, not CUDA-pinned) and each yielded array is
    a view valid until the next iteration; without it, chunks are read on
    the calling thread."""
    path = str(path)
    lib = native_lib()
    if lib is None:
        with open(path, "rb") as f:
            while True:
                data = f.read(chunk_bytes)
                if not data:
                    return
                M.STAGED_BYTES.inc(len(data))
                yield np.frombuffer(data, dtype=np.uint8)
        return
    handle = lib.oim_stream_open(path.encode(), chunk_bytes, n_buffers, int(pin))
    if not handle:
        _raise_last(lib, f"open {path}")
    try:
        while True:
            data_p = ctypes.c_void_p()
            offset = ctypes.c_int64()
            n = lib.oim_stream_next(handle, ctypes.byref(data_p), ctypes.byref(offset))
            if n == 0:
                return
            if n < 0:
                _raise_last(lib, f"stream {path}")
            buf = (ctypes.c_uint8 * n).from_address(data_p.value)
            M.STAGED_BYTES.inc(n)
            try:
                yield np.frombuffer(buf, dtype=np.uint8, count=n)
            finally:
                lib.oim_stream_release(handle, data_p)
    finally:
        M.STAGE_GBPS.set(lib.oim_stream_gbps(handle))
        lib.oim_stream_close(handle)


# -- JPEG decode and single-device staging -----------------------------------


def decode_jpeg_batch(payloads: list[bytes], size: int, n_threads: int = 8):
    """Batch JPEG decode and bilinear resize in the C++ engine: [n, size,
    size, 3] uint8, or None where the engine cannot serve the batch (not
    built, built without the decoder, or a payload that is not JPEG:
    callers fall back to Pillow). A corrupt image raises StagingError
    naming its index."""
    lib = native_lib()
    if lib is None or not hasattr(lib, "oim_decode_jpeg_batch") or not payloads:
        return None
    if any(not p.startswith(b"\xff\xd8") for p in payloads):
        return None
    blob = b"".join(payloads)
    offsets = (ctypes.c_int64 * len(payloads))()
    lengths = (ctypes.c_int64 * len(payloads))()
    pos = 0
    for i, p in enumerate(payloads):
        offsets[i] = pos
        lengths[i] = len(p)
        pos += len(p)
    out = np.empty((len(payloads), size, size, 3), np.uint8)
    got = lib.oim_decode_jpeg_batch(blob, offsets, lengths, len(payloads), size,
                                    out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if got != len(payloads):
        _raise_last(lib, f"jpeg decode batch of {len(payloads)}")
    return out


def stage_file_to_device(path: str | os.PathLike, device="cuda", dtype: str = "uint8",
                         shape: tuple[int, ...] | None = None,
                         chunk_bytes: int = 64 << 20, progress=None):
    """A file onto one device through the data plane (``plane.stage_source``):
    disk reads overlapped with host-to-device copies, each chunk landing
    in one buffer allocated up front, so the device holds the volume and
    no second copy. ``shape`` may hold one -1; None is flat.

    ``progress(bytes_landed)``, called after each chunk lands, returning
    False aborts the stage: the buffer is freed and the function returns
    None."""
    from oim_tpu_torch.controller.backend import torch_dtype
    from oim_tpu_torch.data import plane

    path = str(path)
    src = plane.ExtentSource([plane.Extent("file", path, 0, os.path.getsize(path))])
    tdtype = torch_dtype(dtype)
    if src.total_bytes % tdtype.itemsize:
        raise StagingError(f"{path}: {src.total_bytes} bytes not a multiple of "
                           f"{dtype} itemsize")
    shape = plane.resolve_shape(shape, src.total_bytes // tdtype.itemsize)
    return plane.stage_source(src, dtype=tdtype, shape=shape, device=device,
                              chunk_bytes=chunk_bytes, progress=progress)
