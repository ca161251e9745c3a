"""Feed construction (``oim_tpu/data/feeds.py``): a staged volume into
training batches.

``feeder_batches`` publishes a volume through a ``Feeder`` (the registry's
proxy to a controller, or a controller in this process) and cuts it into
batches as the JAX package's does, for every source kind:

- a file or malloc volume, whole or windowed: with ``--feed-window-bytes
  > 0`` only one window is host-resident at a time (``windowed_batches``,
  over a ``fetch(offset, length)`` callable, so it also runs over
  ``controller.backend.read_window`` without a Feeder); with 0 the volume
  is read once and its records cycled (``_cycle_token_batches``), or
  gathered on the device from a staged tensor (``volume_token_batches``);
- webdataset token shards (``--wds-ext`` members of int32 tokens), whole
  or a shard at a time (``wds_token_stream``, over the same kind of
  callable);
- labeled images, TFRecord-framed tf.Examples or webdataset jpg/cls
  samples, whole or windowed, decoded on the host by the read engine's
  JPEG batch decoder or by Pillow (``_decode_images``). Images stay uint8
  to the device.

The feeder is imported inside ``feeder_batches``, so this module loads
without grpcio and protobuf.
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterator

import numpy as np
import torch

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.data import staging, webdataset


def eval_feed_args(args):
    """The feed arguments for the held-out eval volume, or None when no
    --eval-volume-* source was given. The eval volume stages as
    '<volume>-eval' (its own MapVolume, never shadowing the training
    volume), read whole and never shuffled, so every eval pass sees the
    same batches. Covers all three source kinds: a file, labeled
    TFRecords, and webdataset shards (tokens or jpg/cls)."""
    if not (getattr(args, "eval_volume_file", "") or getattr(args, "eval_volume_tfrecord", "")
            or getattr(args, "eval_volume_webdataset", "")):
        return None
    return argparse.Namespace(**{
        **vars(args),
        "volume": f"{args.volume}-eval",
        "volume_file": getattr(args, "eval_volume_file", ""),
        "volume_tfrecord": getattr(args, "eval_volume_tfrecord", ""),
        "volume_webdataset": getattr(args, "eval_volume_webdataset", ""),
        "feed_window_bytes": 0,
        "shuffle": False,
    })


def refuse_tfrecord_for_llama(args, cfg) -> None:
    """SystemExit for a labeled-image TFRecord volume given to a llama
    model, before anything is published: staging a large volume only to
    find the model cannot take it would waste minutes and device memory."""
    if getattr(args, "volume_tfrecord", "") and cfg.model.startswith("llama"):
        raise SystemExit(
            "--volume-tfrecord holds labeled tf.Example images (feeds "
            "resnet); llama-family models take --volume-file or "
            "--volume-webdataset token volumes")


def feeder_batches(args, cfg, tls, start_batch: int = 0, feeder=None):
    """Batches from a feeder-published volume: a webdataset shard list
    (``--volume-webdataset``: tokens for a llama model, jpg/cls images
    otherwise), labeled TFRecords (``--volume-tfrecord``), a file
    (``--volume-file``) or the controller's malloc buffer.

    Default (--feed-window-bytes > 0): a WINDOWED stream, only one window
    (a shard, for webdataset) of the volume host-resident at a time
    (ranged ReadVolume through the proxy or straight to the controller),
    so a volume larger than host memory trains fine. With
    --feed-window-bytes 0 the whole volume is read once and batches are
    its records; a local-mode token volume staged on the trainer's device
    is gathered there, without a host round trip.

    ``feeder`` shares one Feeder across rebuilds (SeekableFeed seeks): its
    publish cache makes the volume's MapVolume a one-time cost."""
    # controller.backend imports data.plane, whose package imports this
    # module; the feeder needs grpcio, which the card's path never loads.
    from oim_tpu_torch.controller.backend import numpy_dtype
    from oim_tpu_torch.feeder import Feeder
    from oim_tpu_torch.spec import oim_pb2 as pb

    if feeder is None:
        feeder = Feeder(
            registry_address=args.registry,
            controller_id=args.controller_id,
            tls=tls,
            direct_data=getattr(args, "direct_data", True),
        )
    req = pb.MapVolumeRequest(volume_id=args.volume)
    if getattr(args, "volume_webdataset", ""):
        req.webdataset.shard_urls.extend(u for u in args.volume_webdataset.split(",") if u)
    elif getattr(args, "volume_tfrecord", ""):
        refuse_tfrecord_for_llama(args, cfg)
        req.tfrecord.paths.extend(p for p in args.volume_tfrecord.split(",") if p)
    elif args.volume_file:
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
    kind = req.WhichOneof("params")
    if kind == "webdataset":
        urls = list(req.webdataset.shard_urls)
        if llama:
            # Shards are tars, so windows are shard-granular (a byte window
            # could split a header).
            yield from _webdataset_token_batches(args, cfg, feeder, urls, start_batch)
        else:
            yield from _webdataset_image_batches(args, cfg, feeder, urls, start_batch)
        return
    if kind == "tfrecord":
        yield from _tfrecord_image_batches(args, cfg, feeder, start_batch)
        return
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
            "use --volume-tfrecord or --volume-webdataset jpg/cls for "
            "supervised vision")
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
            "use --volume-tfrecord or --volume-webdataset jpg/cls for "
            "supervised vision")
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

    for raw in windowed_batches(_window_fetch(args, feeder), window, rec_bytes, need,
                                first=(first, total)):
        yield to_batch(raw)


def _window_fetch(args, feeder) -> Callable[[int, int], tuple[np.ndarray, int]]:
    """``fetch(offset, length) -> (bytes, total)`` over the Feeder's healed
    window reads of ``args.volume``."""
    def fetch(offset: int, length: int):
        raw, n, _ = feeder.fetch_window(args.volume, offset, length,
                                        timeout=args.publish_timeout, heal=True)
        return raw, n

    return fetch


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


def _fetch_whole(args, feeder) -> np.ndarray:
    """The published volume's bytes on the host (uint8)."""
    return np.asarray(feeder.fetch(args.volume, timeout=args.publish_timeout)).reshape(-1)


def _webdataset_token_batches(args, cfg, feeder, urls: list[str], start_batch: int = 0):
    """Samples of a staged webdataset volume -> token batches. The staged
    bytes are the shards back to back; each sample's --wds-ext payload
    holds raw int32 tokens, in shard order.

    Streaming (--feed-window-bytes > 0, the default): the shard
    boundaries are recomputed from the URLs and one shard at a time is
    read through the volume's data window (``wds_token_stream``). Whole
    (--feed-window-bytes 0): every shard read once, --shuffle permutes."""
    ext = getattr(args, "wds_ext", "bin")
    if getattr(args, "feed_window_bytes", 0) <= 0:
        tokens = _wds_tokens(_fetch_whole(args, feeder), ext, args.volume)
        if tokens.size == 0:
            raise SystemExit(
                f"webdataset volume {args.volume!r} has no samples with extension {ext!r}")
        from_context().info("webdataset volume published", volume=args.volume,
                            tokens=tokens.size)
        yield from _cycle_token_batches(tokens, cfg, args.volume, _shuffle_seed(args),
                                        start_batch)
        return
    sizes = webdataset.shard_sizes(urls)
    from_context().info("webdataset streaming feed", volume=args.volume, shards=len(urls),
                        max_shard_bytes=int(max(sizes)))
    for rows in wds_token_stream(_window_fetch(args, feeder), sizes, cfg.seq_len + 1,
                                 cfg.batch_size, ext, args.volume):
        yield {"tokens": rows}


def wds_token_stream(fetch: Callable[[int, int], tuple[np.ndarray, int]], sizes: list[int],
                     span: int, batch: int, ext: str = "bin",
                     volume: str = "") -> Iterator[np.ndarray]:
    """Endless int32 [batch, span] token batches of a staged webdataset
    volume, read a shard at a time: ``fetch(offset, length)`` gives (the
    bytes [offset, offset + length) of the volume, its total bytes), and
    ``sizes`` are the shards' sizes in staging order. Tokens carry across
    shards; rows carry across the epoch's end, so a batch may straddle
    it; the partial-row token tail is dropped at each wrap, so every epoch
    frames its rows alike, as the whole volume's ``_cycle_token_batches``
    does. A staged size other than the shards' sum (shards changed since
    staging) and a pass that gives no batch stop the feed."""
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    carry = np.zeros((0,), np.int32)
    rows = np.zeros((0, span), np.int32)
    produced = checked = False
    while True:
        for i, size in enumerate(sizes):
            shard, total = fetch(int(offsets[i]), int(size))
            if not checked:
                # A shard whose size changed since staging would slice
                # windows mid-tar: fail with the cause, not a tar error.
                if int(offsets[-1]) != int(total):
                    raise SystemExit(
                        f"webdataset volume {volume!r}: staged volume is {total} bytes "
                        f"but the shard URLs now sum to {int(offsets[-1])} — shards "
                        f"changed since staging?")
                checked = True
            toks = _wds_tokens(shard, ext, volume)
            if toks.size:
                carry = np.concatenate([carry, toks])
                n = (carry.size // span) * span
                if n:
                    rows = np.concatenate([rows, carry[:n].reshape(-1, span)])
                    carry = carry[n:]
            while rows.shape[0] >= batch:
                produced = True
                yield rows[:batch]
                rows = rows[batch:]
        if not produced:
            raise SystemExit(
                f"webdataset volume {volume!r}: one full pass over {len(sizes)} shards "
                f"produced no {ext!r} token batches")
        carry = carry[:0]


_DECODE_POOL = None


def _decode_pool():
    """The shared image-decode thread pool: Pillow releases the
    interpreter lock while it decodes, so a window's images decode in
    parallel."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        import concurrent.futures
        import os

        _DECODE_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 4), thread_name_prefix="oim-image-decode")
    return _DECODE_POOL


def _decode_images(payloads: list, cfg) -> list:
    """JPEG/PNG payloads -> [uint8 [S, S, 3]] in order: the read engine's
    batch decoder where it serves the batch, else the Pillow pool. Images
    stay uint8 to the device (the model normalizes them there)."""
    from oim_tpu_torch.data import readers

    arr = None
    try:
        arr = staging.decode_jpeg_batch(payloads, cfg.image_size)
    except staging.StagingError as err:
        from_context().warning("native jpeg decode failed; falling back to Pillow",
                               error=str(err)[:120])
    if arr is not None:
        return list(arr)

    def one(p):
        return readers.resize_image(readers.decode_image(p), cfg.image_size)

    return list(_decode_pool().map(one, payloads))


def _decode_examples(records, cfg, volume: str) -> list:
    """Serialized tf.Examples -> [(image uint8, label)], decoded as one
    batch."""
    from oim_tpu_torch.data import readers

    payloads, labels = [], []
    for rec in records:
        p, lab = _example_payload(readers.parse_example(rec), volume, cfg)
        payloads.append(p)
        labels.append(lab)
    return list(zip(_decode_images(payloads, cfg), labels))


def _check_label(label: int, cfg, origin: str) -> int:
    """Apply --label-offset and check the label against --num-classes. A
    one-hot silently zeroes a class out of range; the usual cause is the
    ImageNet-TFRecord convention, whose labels are 1-based."""
    label += cfg.label_offset
    if not 0 <= label < cfg.num_classes:
        raise SystemExit(
            f"{origin}: label {label} (after --label-offset "
            f"{cfg.label_offset}) outside [0, {cfg.num_classes}); "
            "ImageNet-convention records are 1-based — use "
            "--num-classes 1001 or --label-offset -1")
    return label


def _example_payload(ex: dict, volume: str, cfg):
    """Parsed tf.Example -> (image bytes, label): the ImageNet-TFRecord
    keys image/encoded and image/class/label."""
    img = ex.get("image/encoded")
    if not img:
        raise SystemExit(
            f"volume {volume!r}: tf.Example has no image/encoded feature (found {sorted(ex)})")
    label = ex.get("image/class/label")
    if label is None or not len(label):
        raise SystemExit(f"volume {volume!r}: tf.Example has no image/class/label feature")
    return img[0], _check_label(int(label[0]), cfg, f"volume {volume!r}")


def _cycled_images(imgs: list, labs: list, args, cfg, start_batch: int) -> Iterator[dict]:
    images, labels = np.stack(imgs), np.asarray(labs, np.int32)
    for idx in _cycle_indices(images.shape[0], cfg.batch_size, _shuffle_seed(args),
                              start_batch):
        yield {"images": images[idx], "labels": labels[idx]}


def _take_image_batches(imgs: list, labs: list, batch: int) -> Iterator[dict]:
    """Every whole batch of the decoded images so far, removed from the
    lists."""
    while len(imgs) >= batch:
        yield {"images": np.stack(imgs[:batch]),
               "labels": np.asarray(labs[:batch], np.int32)}
        del imgs[:batch], labs[:batch]


def _tfrecord_image_batches(args, cfg, feeder, start_batch: int = 0):
    """Labeled (image, label) batches of a staged TFRecord volume, whose
    staged bytes keep the TFRecord framing. Whole: every record decoded
    once and cycled (--shuffle permutes). Windowed: framed bytes carry
    across windows and whole records decode as they complete."""
    from oim_tpu_torch.data import readers

    window = getattr(args, "feed_window_bytes", 0)
    if window <= 0:
        samples = _decode_examples(
            list(readers.iter_tfrecord_bytes(_fetch_whole(args, feeder))), cfg, args.volume)
        if not samples:
            raise SystemExit(f"volume {args.volume!r} holds no tf.Examples")
        from_context().info("labeled tfrecord volume published", volume=args.volume,
                            examples=len(samples))
        yield from _cycled_images([im for im, _ in samples], [lab for _, lab in samples],
                                  args, cfg, start_batch)
        return
    from_context().info("labeled tfrecord streaming feed", volume=args.volume,
                        window_bytes=window)
    fetch = _window_fetch(args, feeder)
    carry = np.zeros((0,), np.uint8)
    imgs: list[np.ndarray] = []
    labs: list[int] = []
    offset, produced = 0, False
    while True:
        w, total = fetch(offset, window)
        offset += w.size
        w8 = np.asarray(w, np.uint8)
        carry = np.concatenate([carry, w8]) if carry.size else w8
        cut = readers.complete_tfrecord_prefix(carry)
        for im, lab in _decode_examples(list(readers.iter_tfrecord_bytes(carry[:cut])), cfg,
                                        args.volume):
            imgs.append(im)
            labs.append(lab)
        carry = carry[cut:]
        for b in _take_image_batches(imgs, labs, cfg.batch_size):
            produced = True
            yield b
        if offset >= total:
            if not produced and not imgs:
                raise SystemExit(
                    f"volume {args.volume!r}: a full pass produced no tf.Example records")
            # Framing restarts at the volume's head: a partial record's
            # bytes cannot continue across the wrap.
            offset, carry = 0, carry[:0]


def _wds_image_sample(sample: dict, cfg):
    """A jpg/cls sample -> (image bytes, label), or None without an image
    member."""
    payload = sample.get("jpg") or sample.get("jpeg") or sample.get("png")
    if payload is None:
        return None
    cls = sample.get("cls")
    if cls is None:
        raise SystemExit(
            f"webdataset image sample has no 'cls' member (label); members: {sorted(sample)}")
    label = _check_label(int(cls.decode().strip() or 0), cfg,
                         f"webdataset sample {sample.get('__key__', b'?').decode()!r}")
    return payload, label


def _decode_wds_samples(samples, cfg, imgs: list, labs: list) -> None:
    pairs = [p for p in (_wds_image_sample(s, cfg) for s in samples) if p]
    if not pairs:
        return
    imgs.extend(_decode_images([p for p, _ in pairs], cfg))
    labs.extend(lab for _, lab in pairs)


def _webdataset_image_batches(args, cfg, feeder, urls: list[str], start_batch: int = 0):
    """The image twin of ``_webdataset_token_batches``: each sample's
    jpg/png member decoded, its cls member the integer label. Streaming
    is shard-granular; whole supports --shuffle."""
    if getattr(args, "feed_window_bytes", 0) <= 0:
        imgs: list[np.ndarray] = []
        labs: list[int] = []
        _decode_wds_samples(list(webdataset.iter_samples([_fetch_whole(args, feeder)])), cfg,
                            imgs, labs)
        if not imgs:
            raise SystemExit(f"webdataset volume {args.volume!r} has no jpg/cls samples")
        from_context().info("webdataset image volume published", volume=args.volume,
                            samples=len(imgs))
        yield from _cycled_images(imgs, labs, args, cfg, start_batch)
        return
    sizes = webdataset.shard_sizes(urls)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    from_context().info("webdataset image streaming feed", volume=args.volume,
                        shards=len(urls))
    fetch = _window_fetch(args, feeder)
    imgs, labs = [], []
    produced = False
    while True:
        for i, size in enumerate(sizes):
            shard, total = fetch(int(offsets[i]), int(size))
            if int(offsets[-1]) != int(total):
                raise SystemExit(
                    f"webdataset volume {args.volume!r}: staged volume is {total} bytes "
                    f"but the shard URLs now sum to {int(offsets[-1])} — shards changed "
                    f"since staging?")
            _decode_wds_samples(list(webdataset.iter_samples([np.asarray(shard)])), cfg,
                                imgs, labs)
            for b in _take_image_batches(imgs, labs, cfg.batch_size):
                produced = True
                yield b
        # Samples short of a batch carry into the next pass; only a pass
        # that parsed nothing is a dead volume.
        if not produced and not imgs:
            raise SystemExit(
                f"webdataset volume {args.volume!r}: one full pass over {len(urls)} shards "
                f"produced no jpg/cls image batches")
