"""Shard-source readers (``oim_tpu/data/readers.py``): raw files, .npy
and TFRecord.

The TFRecord framing (uint64 length, uint32 masked CRC of the length,
payload, uint32 masked CRC of the payload) is parsed directly, and
serialized tf.Examples at the protobuf wire level, so the hot path needs
neither TensorFlow nor a generated binding. A staged TFRecord volume keeps
its framing: consumers find the records in the staged bytes. The image
helpers (``decode_image``, ``encode_jpeg``, ``resize_image``) use Pillow,
imported inside each, so the module loads where Pillow is missing.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Iterator

import numpy as np

from oim_tpu_torch.data import staging


def read_raw(path: str | Path) -> bytes:
    return Path(path).read_bytes()


def read_npy(path: str | Path) -> np.ndarray:
    return np.load(str(path), allow_pickle=False)


def write_tfrecords(path: str | Path, records: list[bytes]) -> None:
    """Write a TFRecord file (tests + benchmarks); masked crc32c of the
    spec is filled with zeros, which readers here do not verify."""
    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)))
            f.write(b"\0\0\0\0")
            f.write(rec)
            f.write(b"\0\0\0\0")


def read_tfrecord_batch(paths: list[str], record_bytes: int | None = None) -> np.ndarray:
    """TFRecord files as their raw bytes, framing intact, back to back in
    one uint8 array sized up front (each file read into its slice by
    ``staging.read_into``; nothing is concatenated). Consumers find the
    records in the bytes themselves (``iter_tfrecord_bytes``), also across
    windows of the volume, so the framing is never stripped, even where
    every record has one size. ``record_bytes``, when given, is checked:
    every record must have that payload size (a walk of the framing of the
    bytes already read, never a second read)."""
    sizes = [os.path.getsize(p) for p in paths]
    out = staging.alloc_pinned(sum(sizes), pin=False)
    pos = 0
    for p, size in zip(paths, sizes):
        if size:
            staging.read_into(p, out[pos:pos + size])
        if record_bytes is not None:
            for rec in iter_tfrecord_bytes(out[pos:pos + size]):
                if len(rec) != record_bytes:
                    raise ValueError(
                        f"{p}: record of {len(rec)} bytes != declared "
                        f"record_bytes {record_bytes}"
                    )
        pos += size
    return out


def iter_tfrecord_bytes(data: bytes | np.ndarray) -> Iterator[bytes]:
    """Iterate records of TFRecord-framed bytes already in memory (a staged
    volume). Framing: uint64 length, uint32 masked-crc(length), payload,
    uint32 masked-crc(payload); CRCs are not verified on the hot path
    (integrity is the storage system's job). A trailing partial record
    raises: a caller reading windows carries the partial record over
    (``complete_tfrecord_prefix``) instead of dropping it."""
    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    pos, n = 0, len(buf)
    while pos < n:
        if n - pos < 12:
            raise IOError("truncated TFRecord header in staged bytes")
        (length,) = struct.unpack_from("<Q", buf, pos)
        end = pos + 12 + length + 4
        if end > n:
            raise IOError("truncated TFRecord payload in staged bytes")
        yield buf[pos + 12:pos + 12 + length]
        pos = end


def complete_tfrecord_prefix(data: np.ndarray) -> int:
    """Byte length of the whole-records prefix of a framed byte window (the
    carry split point for windowed streaming feeds)."""
    buf = memoryview(data)
    pos, n = 0, len(buf)
    while pos < n:
        if n - pos < 12:
            return pos
        (length,) = struct.unpack_from("<Q", buf, pos)
        end = pos + 12 + length + 4
        if end > n:
            return pos
        pos = end
    return pos


# ------------------------------------------------------------- tf.Example --
# Serialized tf.Example protos are parsed/written at the wire-format level —
# the hot path depends on neither TensorFlow nor a generated binding (the
# same stance as the TFRecord framing above). Schema:
#   Example{ features=1 } ; Features{ map<string, Feature> feature=1 }
#   Feature{ oneof: bytes_list=1 | float_list=2 | int64_list=3 }
#   BytesList{ repeated bytes value=1 } ; Float/Int64List possibly packed.


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_proto_fields(buf: bytes):
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    for field, wire, val in _iter_proto_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _iter_proto_fields(val) if f == 1]
        if field == 2:  # FloatList (packed or repeated fixed32)
            floats: list[float] = []
            for f, w, v in _iter_proto_fields(val):
                if f != 1:
                    continue
                if w == 2:
                    floats.extend(np.frombuffer(v, "<f4").tolist())
                else:
                    floats.extend(struct.unpack("<f", v))
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List (packed or repeated varint)
            ints: list[int] = []
            for f, w, v in _iter_proto_fields(val):
                if f != 1:
                    continue
                if w == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(x)
                else:
                    ints.append(v)
            # Two's-complement back to signed.
            return np.asarray(
                [x - (1 << 64) if x >= (1 << 63) else x for x in ints],
                np.int64,
            )
    return []


def parse_example(payload: bytes) -> dict[str, object]:
    """Serialized tf.Example -> {feature name: list[bytes] | int64 array |
    float32 array}."""
    out: dict[str, object] = {}
    for field, _, features_buf in _iter_proto_fields(payload):
        if field != 1:
            continue
        for f, _, entry in _iter_proto_fields(features_buf):
            if f != 1:
                continue
            key, feat = b"", b""
            for ef, _, ev in _iter_proto_fields(entry):
                if ef == 1:
                    key = ev
                elif ef == 2:
                    feat = ev
            out[key.decode()] = _parse_feature(feat)
    return out


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features: dict[str, object]) -> bytes:
    """Build a serialized tf.Example (tests/benchmarks — the writer twin of
    parse_example). Values: bytes / list[bytes] -> BytesList; ints ->
    packed Int64List; floats -> packed FloatList."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, bytes):
            value = [value]
        if isinstance(value, (list, tuple)) and value and isinstance(value[0], bytes):
            feat = _ld(1, b"".join(_ld(1, v) for v in value))
        else:
            arr = np.asarray(value)
            if arr.ndim == 0:
                arr = arr[None]
            if np.issubdtype(arr.dtype, np.integer):
                feat = _ld(3, _ld(1, b"".join(_varint(int(v)) for v in arr)))
            else:
                feat = _ld(2, _ld(1, arr.astype("<f4").tobytes()))
        entries += _ld(1, _ld(1, key.encode()) + _ld(2, feat))
    return _ld(1, entries)


# ------------------------------------------------------------ image decode --


def decode_image(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> [H, W, 3] uint8 RGB (Pillow)."""
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def encode_jpeg(arr: np.ndarray, quality: int = 90) -> bytes:
    """[H, W, 3] uint8 -> JPEG bytes (Pillow)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def resize_image(arr: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [size, size, 3] uint8 (bilinear)."""
    if arr.shape[0] == size and arr.shape[1] == size:
        return arr
    from PIL import Image

    return np.asarray(Image.fromarray(arr).resize((size, size)))
