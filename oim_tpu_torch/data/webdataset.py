"""WebDataset shards (``oim_tpu/data/webdataset.py``): tar indexing,
sample iteration and shard reads.

A webdataset is a sequence of plain tar files ("shards"); files that share
a basename form one sample, keyed by extension (``00001.bin`` +
``00001.cls`` -> {"bin": ..., "cls": ...}).

- ``index_shard``: offset and size of every member, without extracting:
  a staged volume stays flat bytes on the device, and the index makes its
  samples addressable inside it (as the TFRecord framing does in
  readers.py).
- ``iter_samples``: samples grouped in shard order, nothing decoded.
- ``read_shards``: the whole-read staging entry point; a shard is a local
  path or an http(s) object (``objectstore`` range reads).
"""

from __future__ import annotations

import dataclasses
import io
import os
import tarfile
from typing import Iterable, Iterator

import numpy as np

from oim_tpu_torch.data import objectstore, staging


@dataclasses.dataclass(frozen=True)
class TarEntry:
    name: str
    offset: int  # byte offset of the member DATA inside the shard
    size: int

    @property
    def key(self) -> str:
        """Sample key: path up to the FIRST dot of the basename (the
        WebDataset convention — '0001.seg.png' belongs to sample '0001'
        under extension 'seg.png')."""
        dirname, _, base = self.name.rpartition("/")
        stem = base.split(".", 1)[0]
        return f"{dirname}/{stem}" if dirname else stem

    @property
    def ext(self) -> str:
        base = self.name.rsplit("/", 1)[-1]
        parts = base.split(".", 1)
        return parts[1] if len(parts) > 1 else ""


class _MemFile(io.RawIOBase):
    """Zero-copy read/seek file view over a buffer (tarfile only needs
    read/seek/tell; only the 512-byte headers it reads are materialized)."""

    def __init__(self, view: memoryview):
        self._view = view
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._view) - self._pos
        out = bytes(self._view[self._pos:self._pos + n])
        self._pos += len(out)
        return out

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = len(self._view) + offset
        return self._pos

    def tell(self) -> int:
        return self._pos


def _as_view(data: bytes | np.ndarray) -> memoryview:
    if isinstance(data, np.ndarray):
        return memoryview(np.ascontiguousarray(data, dtype=np.uint8)).cast("B")
    return memoryview(data)


_BLOCK = 512


def index_shard(data: bytes | np.ndarray) -> list[TarEntry]:
    """Index every regular file without extracting or copying (offsets
    address into ``data`` directly). Walks a CONCATENATED shard sequence —
    what a staged multi-shard volume (read_shards) holds — by strictly
    parsing one archive at a time and skipping only the all-zero
    end-of-archive padding between them. Unlike tarfile's ignore_zeros
    (which also skips INVALID blocks), a corrupted header still raises
    tarfile.ReadError — damaged shards fail loudly, never silently losing
    samples."""
    view = _as_view(data)
    n = len(view)
    entries = []
    pos = 0
    while pos + _BLOCK <= n:
        block = view[pos:pos + _BLOCK]
        if bytes(block).count(0) == _BLOCK:  # end-of-archive padding
            pos += _BLOCK
            continue
        last_end = pos
        with tarfile.open(fileobj=_MemFile(view[pos:]), mode="r:") as tf:
            got_any = False
            for member in tf:
                got_any = True
                if member.isfile():
                    entries.append(TarEntry(
                        member.name, pos + member.offset_data, member.size
                    ))
                data_blocks = -(-member.size // _BLOCK) * _BLOCK
                last_end = pos + member.offset_data + data_blocks
            if not got_any:
                break
        pos = last_end
    return entries


def iter_samples(
    shards: Iterable[bytes | np.ndarray],
) -> Iterator[dict[str, bytes]]:
    """Group tar members into samples by shared basename, in shard order.

    Yields {"__key__": key, "<ext>": payload, ...}. Members of one sample
    must be adjacent in the tar (the WebDataset convention — sorted names).
    Only the yielded payloads are copied out of the shard buffer.
    """
    for shard in shards:
        view = _as_view(shard)
        current_key = None
        sample: dict[str, bytes] = {}
        for entry in index_shard(shard):
            if entry.key != current_key:
                if sample:
                    yield sample
                current_key = entry.key
                sample = {"__key__": entry.key.encode()}
            sample[entry.ext] = bytes(view[entry.offset:entry.offset + entry.size])
        if sample:
            yield sample


def read_shard(url: str, headers: dict[str, str] | None = None) -> np.ndarray:
    """One shard -> uint8 array: http(s) URLs by parallel range reads,
    local paths by ``staging.read_pinned``."""
    if objectstore.is_url(url):
        return objectstore.read_object(url, headers)
    return staging.read_pinned(url)


def read_shards(
    urls: list[str], headers: dict[str, str] | None = None
) -> np.ndarray:
    """Staging entry point: all shards back to back in one flat uint8
    array (each shard stays a valid tar at its offset). The destination
    is one allocation sized up front from ``shard_sizes``, and every shard
    is read straight into its slice: nothing is concatenated. Shard
    boundaries are recoverable from ``shard_sizes``."""
    if not urls:
        return np.zeros((0,), dtype=np.uint8)
    if len(urls) == 1:
        return read_shard(urls[0], headers)
    sizes = shard_sizes(urls, headers)
    out = staging.alloc_pinned(int(sum(sizes)), pin=False)
    offset = 0
    for url, size in zip(urls, sizes):
        dst = out[offset:offset + size]
        if objectstore.is_url(url):
            objectstore.read_object(url, headers, out=dst)
        else:
            staging.read_into(url, dst)
        offset += size
    return out


def shard_sizes(urls: list[str], headers: dict[str, str] | None = None) -> list[int]:
    """Byte size of each shard without downloading (HEAD / stat)."""
    return [
        objectstore.content_length(u, headers) if objectstore.is_url(u)
        else os.path.getsize(u)
        for u in urls
    ]
