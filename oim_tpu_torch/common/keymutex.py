"""Hashed keyed mutex (reference: k8s keymutex used at controller.go:44-51 and
pkg/oim-csi-driver/serialize.go:13-16).

Serializes operations on the same key (volume ID) while letting different keys
proceed concurrently; a fixed pool of locks indexed by key hash bounds memory.

The port's copy of ``oim_tpu/common/keymutex.py``; it imports nothing of
that package.
"""

from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Iterator


class KeyMutex:
    def __init__(self, pool_size: int = 32):
        self._locks = [threading.Lock() for _ in range(pool_size)]

    def _lock_for(self, key: str) -> threading.Lock:
        return self._locks[zlib.crc32(key.encode()) % len(self._locks)]

    @contextlib.contextmanager
    def locked(self, key: str) -> Iterator[None]:
        lock = self._lock_for(key)
        with lock:
            yield
