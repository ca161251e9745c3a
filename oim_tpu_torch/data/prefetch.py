"""Background feed prefetch (``oim_tpu/data/prefetch.py``, copied):
overlap staging/decode with training.

The feed generators (cli/oim_trainer.py) do real work between batches —
ReadVolume windows through the proxy, tar/TFRecord parsing, JPEG decode.
Run synchronously that work serializes with the train step's host time;
wrapped in ``prefetch_batches`` it runs in a daemon thread up to ``depth``
batches ahead, so window N+1 is fetched and decoded while the device trains
on window N — the trainer-side half of the staging-overlap rule (the
controller-side half is the chunked read-ahead -> DMA path in
controller/cuda_backend.py; both apply the reference's data-plane-off-the-
control-path design, README.md:153-170).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

_DONE = object()


def prefetch_batches(it: Iterator, depth: int = 2) -> Iterator:
    """Iterate ``it`` from a background thread, keeping up to ``depth``
    items ready. Exceptions in the producer re-raise at the consumer's next
    pull; a consumer that stops early leaves only a daemon thread parked on
    a bounded queue (no unbounded memory growth)."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    errors: list[BaseException] = []

    def fill() -> None:
        try:
            for item in it:
                q.put(item)
        except BaseException as exc:  # noqa: BLE001 - re-raised at consumer
            errors.append(exc)
        finally:
            q.put(_DONE)

    threading.Thread(target=fill, daemon=True, name="oim-feed-prefetch").start()
    while True:
        item = q.get()
        if item is _DONE:
            if errors:
                raise errors[0]
            return
        yield item
