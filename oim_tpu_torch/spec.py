"""The request messages the data plane reads (``oim_tpu/spec/oim.proto``),
as plain dataclasses with the proto messages' field names.

The card machine has no ``protobuf``, so the port's controller takes these
in place of ``pb.ArraySpec``, ``pb.FileParams`` and the other params
messages (fields in the proto's order); the gRPC surface that carries
them is not ported yet (ROADMAP A.4). ``spec_bytes`` stands in for
``SerializeToString(deterministic=True)`` where the stage cache keys on
the spec.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """How a staged volume is viewed: an empty ``shape`` keeps the source's
    shape (or flat), an empty ``dtype`` the source's dtype (or uint8);
    ``sharding_axes`` names a mesh axis per dimension ("" = replicated)."""

    shape: tuple[int, ...] = ()
    dtype: str = ""
    sharding_axes: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class FileParams:
    path: str = ""
    format: str = ""  # "raw" (the default) or "npy"


@dataclasses.dataclass(frozen=True)
class TFRecordParams:
    paths: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class WebDatasetParams:
    shard_urls: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CephParams:
    """A Ceph image read through the cluster's HTTP object gateway:
    ``monitors`` names the gateway endpoint, ``pool``/``image`` the
    object, ``user``/``secret`` the HTTP Basic credentials."""

    monitors: str = ""
    user: str = ""
    secret: str = ""
    pool: str = ""
    image: str = ""


@dataclasses.dataclass(frozen=True)
class MallocParams:
    pass


@dataclasses.dataclass(frozen=True)
class StageStatus:
    """``StageStatusReply``: what a volume's stager reports."""

    ready: bool
    bytes_staged: int
    gbps: float
    error: str


def spec_bytes(spec: ArraySpec) -> bytes:
    """A deterministic encoding of ``spec``: equal specs give equal bytes,
    different specs different bytes."""
    return json.dumps([[int(d) for d in spec.shape], spec.dtype,
                       list(spec.sharding_axes)]).encode()
