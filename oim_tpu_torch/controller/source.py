"""Source loading for the whole-read staging path
(``oim_tpu/controller/source.py``): MapVolume params into a host numpy
array. Ported: ``file`` (raw and npy); the other kinds raise
NotImplementedError naming their ROADMAP item."""

from __future__ import annotations

from typing import Any

import numpy as np

from oim_tpu_torch.data import readers, staging

# Source kinds load_source accepts ("malloc" is backend-level, not a source).
SOURCES = ("file",)

_NOT_PORTED = {
    "tfrecord": "the TFRecord reader (ROADMAP A.2)",
    "webdataset": "the webdataset reader (ROADMAP A.2)",
    "ceph": "the object-store source (ROADMAP A.2)",
}


def load_source(params_kind: str, params: Any) -> np.ndarray:
    if params_kind == "file":
        fmt = params.format or "raw"
        if fmt == "npy":
            return readers.read_npy(params.path)
        if fmt == "raw":
            return staging.read_pinned(params.path)
        raise ValueError(f"unknown file format {fmt!r}")
    if params_kind in _NOT_PORTED:
        raise NotImplementedError(
            f"{params_kind} sources are not ported yet: {_NOT_PORTED[params_kind]}")
    raise ValueError(f"unknown params kind {params_kind!r}")
