"""Shuffle buffer for streaming feeds (``oim_tpu/data/shuffle.py``, copied).

Windowed feeds (cli/oim_trainer.py) stream a volume in storage order —
whole-volume feeds reshuffle per epoch, but a stream can't permute what it
hasn't seen. The standard fix is a bounded reservoir over RECORDS: hold the
next ``buffer_records`` samples, emit batches drawn uniformly from the
buffer, refill from the stream. Randomness quality degrades gracefully with
buffer size, memory stays bounded at buffer + one batch — the same
contract as tf.data's shuffle().
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def shuffle_batches(
    batches: Iterator[dict], buffer_records: int, seed: int = 0
) -> Iterator[dict]:
    """Record-level shuffle over a stream of dict-of-arrays batches.

    Every incoming batch's leading axis is split into records that enter a
    reservoir of up to ``buffer_records``; outgoing batches (same batch
    size, same keys) are drawn uniformly without replacement. A finite
    stream's tail is flushed in shuffled order in FULL batches; a final
    remainder smaller than one batch is dropped — emitted batches keep a
    uniform shape so jitted consumers never recompile (the training feeds
    here are infinite cyclers, so nothing is ever dropped in practice).
    """
    rng = np.random.RandomState(seed)
    pools: dict[str, list] = {}
    batch_size = None

    def emit():
        idx = rng.randint(len(next(iter(pools.values()))))
        return {k: pool.pop(idx) for k, pool in pools.items()}

    def stack(records):
        out: dict[str, np.ndarray] = {}
        for k in pools:
            out[k] = np.stack([r[k] for r in records])
        return out

    for batch in batches:
        if batch_size is None:
            batch_size = len(next(iter(batch.values())))
            pools = {k: [] for k in batch}
        for k, v in batch.items():
            pools[k].extend(np.asarray(v))
        while len(next(iter(pools.values()))) >= buffer_records + batch_size:
            yield stack([emit() for _ in range(batch_size)])
    if batch_size is None:
        return
    while len(next(iter(pools.values()))) >= batch_size:
        yield stack([emit() for _ in range(batch_size)])
