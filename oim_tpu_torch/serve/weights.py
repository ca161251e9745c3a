"""Checkpoint params as ONE content-addressed volume
(``oim_tpu/serve/weights.py``): the serving tier's weight distribution.

The ``OIMW0001`` blob: magic + uint64 header length + sorted-JSON
manifest (tree paths, dtypes, shapes, offsets, the tree's structure
string) + raw leaf bytes. The bytes are the JAX package's for the same
tree: a tree packed by either package unpacks in the other. Trees are
nested dicts of tensors (or numpy arrays), flattened in sorted key order
as ``jax.tree_util`` flattens dicts.

A packed file is published through the feeder as a raw ``uint8`` file
volume (``weights_request``, ``publish_weights``): the first replica's
publish stages it, a prestaged replica's is a stage-cache hit, and each
replica restores its tree from the staged bytes (``restore_weights``).
``restore_from_array`` is the restore's core and needs neither grpc nor
protobuf: on a staged CUDA ``uint8`` tensor every leaf is a view of the
volume on the device, except a leaf whose offset in the blob is not a
multiple of its element size, which ``Tensor.view(dtype)`` refuses and
which is copied on the device instead. ``shard > 1`` cuts member
``rank``'s tree (``serve/shard.member_params``' pieces) out of the same
bytes.
"""

from __future__ import annotations

import json
import re
import struct

import numpy as np
import torch

from oim_tpu_torch.controller.backend import torch_dtype

_MAGIC = b"OIMW0001"


def _flatten(tree, prefix=""):
    """[(keystr path, leaf)] in sorted-key order, e.g. "['layers']['wq']"."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}['{k}']")
        return out
    return [(prefix, tree)]


def _treedef(tree) -> str:
    """The structure string ``str(jax.tree_util.tree_structure(tree))``
    gives for a dict tree."""
    def inner(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {inner(t[k])}" for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({inner(tree)})"


def _raw(leaf) -> tuple[np.ndarray, str]:
    """Contiguous host bytes of a leaf and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
    name = arr.dtype.name
    return arr, "bfloat16" if name in ("void16", "bfloat16") else name


def pack_params(params: dict) -> bytes:
    """Serialize a params tree; deterministic for a given tree."""
    manifest, blobs, offset = [], [], 0
    for path, leaf in _flatten(params):
        arr, dtype = _raw(leaf)
        manifest.append({"path": path, "dtype": dtype, "shape": list(arr.shape),
                         "offset": offset, "bytes": int(arr.nbytes)})
        blobs.append(arr)
        offset += arr.nbytes
    header = json.dumps({"leaves": manifest, "treedef": _treedef(params),
                         "total_bytes": offset}, sort_keys=True).encode()
    out = bytearray(_MAGIC)
    out += struct.pack("<Q", len(header))
    out += header
    for arr in blobs:
        out += memoryview(arr).cast("B")
    return bytes(out)


def unpack_params(buf, device="cuda") -> dict:
    """Rebuild the params tree as torch tensors on ``device`` (bf16 leaves
    come back as torch.bfloat16) out of packed bytes (or a numpy or uint8
    tensor view of them): views of the bytes where a leaf's offset allows
    (``_leaf``)."""
    return _tree(_as_bytes(buf).to(device))


def _insert(tree: dict, keystr: str, leaf) -> None:
    """Place a leaf at a keystr path like "['layers']['wq']"."""
    keys = re.findall(r"\['([^']+)'\]", keystr)
    if not keys or "".join(f"['{k}']" for k in keys) != keystr:
        raise ValueError(f"unsupported tree path {keystr!r}")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf


def save_packed(params: dict, path: str) -> int:
    """Pack ``params`` to ``path``; returns the byte size. The file is the
    volume source ``publish_weights`` publishes."""
    blob = pack_params(params)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def weights_params(path: str, total_bytes: int):
    """(ArraySpec, FileParams) of a packed weights file as a raw ``uint8``
    volume: what ``weights_request`` sends, in the port's grpc-free
    dataclasses (a backend's ``stage`` takes them directly)."""
    from oim_tpu_torch.spec import ArraySpec, FileParams

    return (ArraySpec(shape=(int(total_bytes),), dtype="uint8"),
            FileParams(path=path, format="raw"))


def weights_request(volume_id: str, path: str, total_bytes: int):
    """The MapVolumeRequest publishing a packed weights file (shared by
    publish and prestage, so the content key is the same on every
    replica)."""
    from oim_tpu_torch.controller.controller import array_spec_proto
    from oim_tpu_torch.spec import oim_pb2 as pb

    spec, params = weights_params(path, total_bytes)
    return pb.MapVolumeRequest(
        volume_id=volume_id, spec=array_spec_proto(spec),
        file=pb.FileParams(path=params.path, format=params.format))


def publish_weights(feeder, volume_id: str, path: str, timeout: float = 300.0):
    """Publish a packed weights file through ``feeder`` (local or remote);
    returns the PublishedVolume."""
    import os

    from oim_tpu_torch.common.logging import from_context

    request = weights_request(volume_id, path, os.path.getsize(path))
    pub = feeder.publish(request, timeout=timeout)
    from_context().info("published weights volume", volume=volume_id, bytes=pub.bytes)
    return pub


# What the latest restore in this process staged: bytes_staged at rank k
# is the member's weight footprint (split leaves 1/shard of their bytes,
# replicated leaves their full size).
LAST_RESTORE: dict = {}


def _shard_axis(keystr: str, ndim: int) -> int | None:
    """The Megatron split axis of one manifest leaf (None = replicated):
    COL leaves their last dim, ROW leaves dim 1 (serve/shard.py's sets)."""
    from oim_tpu_torch.serve.shard import COL, ROW

    name = re.findall(r"\['([^']+)'\]", keystr)[-1]
    if name in COL:
        return ndim - 1
    if name in ROW:
        return 1
    return None


def _as_bytes(data) -> torch.Tensor:
    """A flat ``uint8`` tensor over ``data`` (bytes, a numpy array or a
    tensor of any dtype), sharing its memory where it can."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8)
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        # torch refuses to share a read-only buffer (bytes, a mapped file).
        data = torch.from_numpy(data if data.flags.writeable else data.copy())
    return data.contiguous().reshape(-1).view(torch.uint8)


def _header(data: torch.Tensor) -> tuple[dict, int]:
    """(the manifest, the offset of the first leaf's bytes); only the
    header's bytes leave the device."""
    head = data[:len(_MAGIC) + 8].cpu().numpy().tobytes()
    if head[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a packed oim weights blob (bad magic)")
    (hlen,) = struct.unpack("<Q", head[len(_MAGIC):])
    body = len(_MAGIC) + 8
    return json.loads(data[body:body + hlen].cpu().numpy().tobytes()), body + hlen


def _leaf(data: torch.Tensor, start: int, leaf: dict) -> torch.Tensor:
    """One leaf over the blob's bytes: a view where its offset is a
    multiple of its element size, else a copy on the same device."""
    dtype = torch_dtype(leaf["dtype"])
    raw = data[start:start + leaf["bytes"]]
    if start % dtype.itemsize:
        raw = raw.clone()
    return raw.view(dtype).reshape(leaf["shape"])


def _tree(data: torch.Tensor) -> dict:
    """The whole tree over the blob's bytes, each leaf as in ``_leaf``."""
    header, base = _header(data)
    tree: dict = {}
    for leaf in header["leaves"]:
        _insert(tree, leaf["path"], _leaf(data, base + leaf["offset"], leaf))
    return tree


def _unpack_shard(data: torch.Tensor, shard: int, rank: int) -> dict:
    """Member ``rank``'s tree out of the blob's bytes: each split leaf as
    its 1/shard slice, one compact copy, replicated leaves as in
    ``_leaf``. Every rank derives the slices from the same manifest."""
    header, base = _header(data)
    tree: dict = {}
    staged = 0
    for leaf in header["leaves"]:
        arr = _leaf(data, base + leaf["offset"], leaf)
        axis = _shard_axis(leaf["path"], arr.dim())
        if axis is not None:
            n = arr.shape[axis]
            if n % shard:
                raise ValueError(f"leaf {leaf['path']} dim {axis} ({n}) does not "
                                 f"divide by shard={shard}")
            width = n // shard
            arr = arr.narrow(axis, rank * width, width).contiguous()
        staged += arr.numel() * arr.element_size()
        _insert(tree, leaf["path"], arr)
    LAST_RESTORE.clear()
    LAST_RESTORE.update(shard=shard, rank=rank, bytes_staged=staged,
                        total_bytes=int(header["total_bytes"]))
    return tree


def restore_from_array(data, *, shard: int = 1, rank: int = 0) -> dict:
    """The params tree from a staged weights volume's array (a ``uint8``
    tensor on the host or the card, a numpy array or bytes), on the
    array's own device: the engine places it. The grpc-free core of
    ``restore_weights``; ``shard``/``rank`` as there."""
    if not 0 <= rank < max(shard, 1):
        raise ValueError(f"rank {rank} outside shard={shard}")
    data = _as_bytes(data)
    if shard >= 2:
        return _unpack_shard(data, shard, rank)
    tree = _tree(data)
    nbytes = int(data.numel())
    LAST_RESTORE.clear()
    LAST_RESTORE.update(shard=1, rank=0, bytes_staged=nbytes, total_bytes=nbytes)
    return tree


def restore_weights(feeder, volume_id: str, timeout: float = 300.0, *,
                    shard: int = 1, rank: int = 0) -> dict:
    """The params tree from a published weights volume: views of the
    staged array in local mode (on the backend's device), one whole-volume
    window read into host memory in remote mode.
    ``shard > 1``: member ``rank``'s tree of an N-way tensor-parallel
    replica, out of the same volume every member reads."""
    if not 0 <= rank < max(shard, 1):
        raise ValueError(f"rank {rank} outside shard={shard}")
    if feeder.controller is not None:
        volume = feeder.controller.get_volume(volume_id)
        if volume is None:
            raise ValueError(f"no volume {volume_id!r} on the controller")
        data = volume.array
    else:
        raw, _, _ = feeder.fetch_window(volume_id, 0, 0, timeout=timeout)
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return restore_from_array(data, shard=shard, rank=rank)
