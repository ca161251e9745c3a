"""The ``OIMW0001`` packed-weights blob (``oim_tpu/serve/weights.py``):
the port's own copy of ``pack_params`` / ``unpack_params``.

magic + uint64 header length + sorted-JSON manifest (tree paths, dtypes,
shapes, offsets, the tree's structure string) + raw leaf bytes. The bytes
are the JAX package's for the same tree: a tree packed by either package
unpacks in the other. Trees are nested dicts of tensors (or numpy arrays),
flattened in sorted key order as ``jax.tree_util`` flattens dicts.
"""

from __future__ import annotations

import json
import re
import struct

import numpy as np
import torch

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
    come back as torch.bfloat16)."""
    data = np.frombuffer(buf, dtype=np.uint8) if isinstance(
        buf, (bytes, bytearray, memoryview)) else np.asarray(buf).view(np.uint8).reshape(-1)
    if data[:len(_MAGIC)].tobytes() != _MAGIC:
        raise ValueError("not a packed oim weights blob (bad magic)")
    (hlen,) = struct.unpack("<Q", data[len(_MAGIC):len(_MAGIC) + 8].tobytes())
    body = len(_MAGIC) + 8
    header = json.loads(data[body:body + hlen].tobytes())
    base = body + hlen
    tree: dict = {}
    for leaf in header["leaves"]:
        raw = data[base + leaf["offset"]:base + leaf["offset"] + leaf["bytes"]]
        if leaf["dtype"] == "bfloat16":
            t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(raw.view(np.dtype(leaf["dtype"])).copy())
        _insert(tree, leaf["path"], t.reshape(leaf["shape"]).to(device))
    return tree


def _insert(tree: dict, keystr: str, leaf) -> None:
    keys = re.findall(r"\['([^']+)'\]", keystr)
    if not keys or "".join(f"['{k}']" for k in keys) != keystr:
        raise ValueError(f"unsupported tree path {keystr!r}")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf
