"""Feed construction (``oim_tpu/data/feeds.py``): a staged volume into
training batches.

Ported: the whole-volume llama branch of ``feeder_batches`` in local mode
(the staged tensor cut into [batch, seq_len+1] records with the JAX
package's index stream), ``SeekableFeed`` and the index generators. The
windowed feed, the webdataset and TFRecord feeds, image volumes and the
feeder-driven publish are not ported yet (ROADMAP A.2).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class SeekableFeed:
    """A batch iterator that can REPOSITION for checkpoint resume.

    Wraps a feed FACTORY ``make(start_batch) -> iterator``; ``seek(n)``
    rebuilds the feed positioned at batch n. Construction and ``seek`` are
    both lazy: the factory runs at the first ``next()`` after them."""

    def __init__(self, make, start: int = 0):
        self._make = make
        self._start = start
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._make(self._start))
        return next(self._it)

    def seek(self, batch_index: int) -> None:
        self._start = batch_index
        self._it = None


def _cycle_indices(n: int, batch: int, shuffle_seed: int | None = None,
                   start_batch: int = 0) -> Iterator[np.ndarray]:
    """Endless batch-index generator over n records: sequential wraparound
    by default, or permutation-queue shuffling when shuffle_seed is set;
    each permutation is consumed exactly once before the next is drawn, so
    every record is served exactly once per epoch even when batch doesn't
    divide n. ``start_batch`` repositions mid-stream (index work only)."""
    if shuffle_seed is None:
        i = (start_batch * batch) % n if n else 0
        while True:
            yield np.arange(i, i + batch) % n
            i = (i + batch) % n
    rng = np.random.RandomState(shuffle_seed)
    queue = rng.permutation(n)
    skip = start_batch
    while True:
        while queue.size < batch:
            queue = np.concatenate([queue, rng.permutation(n)])
        if skip > 0:
            skip -= 1
        else:
            yield queue[:batch]
        queue = queue[batch:]


def _cycle_token_batches(tokens_flat, cfg, volume: str,
                         shuffle_seed: int | None = None,
                         start_batch: int = 0) -> Iterator[dict]:
    """Flat token stream (a numpy array) -> cyclic [batch, seq_len+1] int32
    numpy batches (the JAX package's record framing and epoch wrap)."""
    span = cfg.seq_len + 1
    n = (tokens_flat.size // span) * span
    if n == 0:
        raise SystemExit(
            f"volume {volume!r} holds {tokens_flat.size} tokens "
            f"< seq_len+1={span}")
    tokens = np.asarray(tokens_flat[:n]).reshape(-1, span).astype(
        np.int32, copy=False)
    for idx in _cycle_indices(tokens.shape[0], cfg.batch_size,
                              shuffle_seed, start_batch):
        yield {"tokens": tokens[idx]}


def volume_token_batches(array: torch.Tensor, cfg, shuffle_seed: int | None = None,
                         start_batch: int = 0) -> Iterator[dict]:
    """A staged token volume -> cyclic {"tokens": int32 [batch, seq_len+1]}
    batches, gathered on the tensor's own device (a CUDA volume feeds the
    trainer without a host round trip). For the same volume and seed the
    batches equal the JAX package's ``_cycle_token_batches``."""
    span = cfg.seq_len + 1
    flat = array.reshape(-1)
    n = (flat.numel() // span) * span
    if n == 0:
        raise SystemExit(
            f"the volume holds {flat.numel()} tokens < seq_len+1={span}")
    records = flat[:n].view(-1, span)
    for idx in _cycle_indices(records.shape[0], cfg.batch_size,
                              shuffle_seed, start_batch):
        rows = torch.from_numpy(idx).to(records.device, non_blocking=True)
        yield {"tokens": records.index_select(0, rows).to(torch.int32)}
