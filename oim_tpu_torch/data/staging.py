"""Host half of the staging engine (``oim_tpu/data/staging.py``): pinned
host buffers and parallel file reads into them.

``read_into`` is the counterpart of the C++ engine's ``oim_read_into``
(``native/staging.cc``): the destination is cut into ranges that a pool of
threads fills with ``os.preadv``, which releases the interpreter lock, so
the reads run in parallel against the page cache or the disk. The JAX
package's io_uring ring, its C++ engine and the JPEG batch decoder are not
ported (ROADMAP A.2).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

# Each thread of a parallel read takes at least this many bytes; smaller
# reads run on the calling thread.
_MIN_THREAD_BYTES = 4 << 20


class StagingError(IOError):
    pass


def read_path() -> str:
    """Which implementation ``read_into`` runs (the JAX package's names
    "native", "io_uring" and "readinto" for its three)."""
    return "preadv"


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


def read_into(path: str | os.PathLike, dst: np.ndarray, offset: int = 0,
              n_threads: int = 8) -> None:
    """Fill ``dst`` (uint8, contiguous) from ``path`` starting at byte
    ``offset``, with up to ``n_threads`` parallel preads; raises
    StagingError when the file holds fewer bytes."""
    path = str(path)
    total = int(dst.size)
    n = max(1, min(n_threads, total // _MIN_THREAD_BYTES))
    fd = os.open(path, os.O_RDONLY)
    try:
        if n == 1:
            got = _pread_full(fd, dst, offset)
        else:
            step = -(-total // n)
            ranges = [(a, min(a + step, total)) for a in range(0, total, step)]
            with concurrent.futures.ThreadPoolExecutor(
                    len(ranges), thread_name_prefix="oim-pread") as pool:
                futs = [pool.submit(_pread_full, fd, dst[a:b], offset + a)
                        for a, b in ranges]
                got = sum(f.result() for f in futs)
    finally:
        os.close(fd)
    if got != total:
        raise StagingError(f"read {path}: got {got} of {total} bytes")


def read_pinned(path: str | os.PathLike, n_threads: int = 8) -> np.ndarray:
    """Whole file into a uint8 array. The JAX package's buffer is
    page-locked when its C++ engine is built; this one is plain memory:
    its one caller, the whole-read staging path, copies it synchronously."""
    arr = alloc_pinned(os.path.getsize(path), pin=False)
    if arr.size:
        read_into(path, arr, n_threads=n_threads)
    return arr
