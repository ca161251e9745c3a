"""Feed construction (``oim_tpu/data/feeds.py``): a staged volume into
training batches.

``feeder_batches`` publishes a file or malloc volume through a ``Feeder``
(the registry's proxy to a controller) and cuts it into batches, whole or
windowed, as the JAX package's does: with ``--feed-window-bytes > 0`` only
one window of the volume is host-resident at a time
(``windowed_batches``, which takes a ``fetch(offset, length)`` callable
and so also runs over ``controller.backend.read_window`` without a
Feeder); with 0 the volume is read once and batches are its records,
cycled (``_cycle_token_batches``), or gathered on the device from a
staged tensor (``volume_token_batches``). The feeder is imported inside
``feeder_batches``, so this module loads without grpcio and protobuf.

Not ported yet: the TFRecord and webdataset volumes through the feeder
(the webdataset token feed around ``_wds_tokens``, the image feeds:
ROADMAP A.3.3-A.3.4).
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterator

import numpy as np
import torch

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.data import webdataset


def eval_feed_args(args):
    """The feed arguments for the held-out eval volume, or None when no
    --eval-volume-file was given. The eval volume stages as
    '<volume>-eval' (its own MapVolume, never shadowing the training
    volume), read whole and never shuffled, so every eval pass sees the
    same batches."""
    if not getattr(args, "eval_volume_file", ""):
        return None
    return argparse.Namespace(**{
        **vars(args),
        "volume": f"{args.volume}-eval",
        "volume_file": args.eval_volume_file,
        "volume_tfrecord": "",
        "volume_webdataset": "",
        "feed_window_bytes": 0,
        "shuffle": False,
    })


def refuse_unported(args) -> None:
    """SystemExit for the volume kinds the port's feeder path lacks."""
    for flag, item in (("volume_tfrecord", "A.3.4"), ("volume_webdataset", "A.3.3-A.3.4")):
        if getattr(args, flag, ""):
            raise SystemExit(
                f"--{flag.replace('_', '-')}: the {flag.split('_')[1]} volume through the "
                f"feeder is not ported yet (ROADMAP {item}); use --volume-file")


def feeder_batches(args, cfg, tls, start_batch: int = 0, feeder=None):
    """Batches from a feeder-published file or malloc volume.

    Default (--feed-window-bytes > 0): a WINDOWED stream, only one window
    of the volume host-resident at a time (ranged ReadVolume through the
    proxy or straight to the controller), so a volume larger than host
    memory trains fine. With --feed-window-bytes 0 the whole volume is
    read once and batches are its records; a local-mode volume staged on
    the trainer's device is gathered there, without a host round trip.

    ``feeder`` shares one Feeder across rebuilds (SeekableFeed seeks):
    its publish cache makes the volume's MapVolume a one-time cost."""
    # controller.backend imports data.plane, whose package imports this
    # module; the feeder needs grpcio, which the card's path never loads.
    from oim_tpu_torch.controller.backend import numpy_dtype
    from oim_tpu_torch.feeder import Feeder
    from oim_tpu_torch.spec import oim_pb2 as pb

    refuse_unported(args)
    if feeder is None:
        feeder = Feeder(
            registry_address=args.registry,
            controller_id=args.controller_id,
            tls=tls,
            direct_data=getattr(args, "direct_data", True),
        )
    req = pb.MapVolumeRequest(volume_id=args.volume)
    if args.volume_file:
        req.file.path = args.volume_file
        req.file.format = "npy" if args.volume_file.endswith(".npy") else "raw"
    else:
        req.malloc.SetInParent()
    pub = feeder.publish(req, timeout=args.publish_timeout)
    window = getattr(args, "feed_window_bytes", 0)
    if start_batch and window > 0:
        raise ValueError(
            "start_batch repositioning is a whole-volume-feed feature "
            "(--feed-window-bytes 0); windowed feeds replay instead")
    llama = cfg.model.startswith("llama")
    if window <= 0:
        seed = _shuffle_seed(args)
        if llama and isinstance(pub.array, torch.Tensor):
            from_context().info("volume published", volume=args.volume,
                                shape=str(tuple(pub.array.shape)))
            yield from volume_token_batches(pub.array, cfg, seed, start_batch)
            return
        data = feeder.fetch(args.volume, timeout=args.publish_timeout)
        from_context().info("volume published", volume=args.volume, shape=str(data.shape))
        if llama:
            yield from _cycle_token_batches(data.reshape(-1), cfg, args.volume, seed,
                                            start_batch)
            return
        # Raw byte volumes carry no labels anywhere: this path is a
        # bandwidth/e2e shape, not supervised training.
        from_context().warning(
            "raw image volume has no labels (training against zeros); "
            "labeled image feeds through the feeder are not ported yet")
        images = np.asarray(data)
        labels = np.zeros((images.shape[0],), np.int32)
        for idx in _cycle_indices(images.shape[0], cfg.batch_size, seed, start_batch):
            yield {"images": images[idx], "labels": labels[idx]}
        return

    # The first window also carries the volume's ArraySpec (dtype/shape).
    first, total, spec = feeder.fetch_window(
        args.volume, 0, window, timeout=args.publish_timeout, heal=True)
    try:
        dt = numpy_dtype(spec.dtype if spec is not None else "")
    except ValueError as e:
        raise SystemExit(f"volume {args.volume!r}: {e}") from None
    if llama:
        rec_bytes = (cfg.seq_len + 1) * dt.itemsize

        def to_batch(raw):
            return {"tokens": raw.view(dt).reshape(cfg.batch_size, -1).astype(np.int32)}
    else:
        if spec is not None and len(spec.shape) > 1:
            sample = tuple(int(d) for d in spec.shape[1:])
        else:
            sample = (cfg.image_size, cfg.image_size, 3)
        rec_bytes = int(np.prod(sample)) * dt.itemsize
        from_context().warning(
            "raw image volume has no labels (training against zeros); "
            "labeled image feeds through the feeder are not ported yet")
        labels = np.zeros((cfg.batch_size,), np.int32)

        def to_batch(raw):
            imgs = raw.view(dt).reshape((cfg.batch_size,) + sample)
            return {"images": np.ascontiguousarray(imgs), "labels": labels}

    need = cfg.batch_size * rec_bytes
    if total < need:
        raise SystemExit(
            f"volume {args.volume!r} holds {total} bytes but one batch needs "
            f"{need} ({cfg.batch_size} records x {rec_bytes}B); shrink the "
            f"batch/seq or use --feed-window-bytes 0 (whole-volume mode)")
    from_context().info(
        "volume published (windowed feed)", volume=args.volume,
        total_bytes=total, window_bytes=window, record_bytes=rec_bytes)

    def fetch(offset: int, length: int):
        raw, n, _ = feeder.fetch_window(args.volume, offset, length,
                                        timeout=args.publish_timeout, heal=True)
        return raw, n

    for raw in windowed_batches(fetch, window, rec_bytes, need, first=(first, total)):
        yield to_batch(raw)


def windowed_batches(fetch: Callable[[int, int], tuple[np.ndarray, int]], window: int,
                     rec_bytes: int, need: int,
                     first: tuple[np.ndarray, int] | None = None) -> Iterator[np.ndarray]:
    """Endless ``need``-byte batches (uint8 numpy) of a volume read in
    windows: ``fetch(offset, length)`` gives (the bytes [offset, offset +
    length) clipped to the volume, the volume's total bytes); ``first`` is
    the window at offset 0 when the caller already holds it. A batch may
    straddle windows (the carry) and records may straddle windows; at the
    volume's end the stream wraps to offset 0, keeping the whole records
    in the carry and dropping only a partial-record byte tail, since the
    next epoch restarts record-aligned."""
    w, total = first if first is not None else fetch(0, window)
    carry = np.zeros((0,), np.uint8)
    offset = w.size
    while True:
        carry = np.concatenate([carry, w]) if carry.size else np.asarray(w)
        while carry.size >= need:
            yield carry[:need]
            carry = carry[need:]
        if offset >= total:
            offset = 0
            carry = carry[:(carry.size // rec_bytes) * rec_bytes]
        w, total = fetch(offset, window)
        offset += w.size


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


def _shuffle_seed(args) -> int | None:
    return getattr(args, "shuffle_seed", 0) if getattr(args, "shuffle", False) else None


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


def _wds_tokens(shard, ext: str = "bin", volume: str = "") -> np.ndarray:
    """The int32 tokens of one tar shard (or of shards back to back, as a
    staged webdataset volume holds them): the payloads under extension
    ``ext`` of every sample, in shard order, as one flat array."""
    payloads = [s[ext] for s in webdataset.iter_samples([np.asarray(shard)]) if ext in s]
    if not payloads:
        return np.zeros((0,), np.int32)
    blob = b"".join(payloads)
    if len(blob) % 4:
        raise SystemExit(
            f"webdataset volume {volume!r}: payloads under extension "
            f"{ext!r} total {len(blob)} bytes, not int32-aligned: is "
            f"{ext!r} the token member?")
    return np.frombuffer(blob, dtype=np.int32)


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
