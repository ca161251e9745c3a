"""Source loading for the whole-read staging path
(``oim_tpu/controller/source.py``): MapVolume params into a host numpy
array (the role of SPDK's bdev constructors in the reference)."""

from __future__ import annotations

from typing import Any

import numpy as np

from oim_tpu_torch.data import objectstore, readers, staging, webdataset

# Source kinds load_source accepts ("malloc" is backend-level, not a
# source). "ceph" reads through the cluster's HTTP object gateway (RGW);
# "webdataset" shard URLs may be local paths or http(s) objects.
SOURCES = ("file", "tfrecord", "webdataset", "ceph")


def load_source(params_kind: str, params: Any) -> np.ndarray:
    if params_kind == "file":
        fmt = params.format or "raw"
        if fmt == "npy":
            return readers.read_npy(params.path)
        if fmt == "raw":
            return staging.read_pinned(params.path)
        raise ValueError(f"unknown file format {fmt!r}")
    if params_kind == "tfrecord":
        return readers.read_tfrecord_batch(list(params.paths))
    if params_kind == "webdataset":
        # Shards are staged as their flat tar bytes; the input pipeline
        # indexes them (data/webdataset.py).
        return webdataset.read_shards(list(params.shard_urls))
    if params_kind == "ceph":
        # The reference maps Ceph volumes as RBD block devices; a volume
        # here is an object behind the cluster's gateway.
        return objectstore.read_object(*objectstore.ceph_object(params))
    raise ValueError(f"unknown params kind {params_kind!r}")
