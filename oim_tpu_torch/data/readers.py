"""Shard-source readers (``oim_tpu/data/readers.py``): ``.npy`` only so
far. Raw files are read by ``data/staging.py``; the TFRecord framing
reader and writer are not ported yet."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_npy(path: str | Path) -> np.ndarray:
    return np.load(str(path), allow_pickle=False)
