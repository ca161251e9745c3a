"""Prefix KV chains as content-addressed volumes (``oim_tpu/serve/kvvolume.py``):
the fleet tier.

A prefix chain's K/V is a pure function of its token chain, which makes it
CONTENT: the ``OIMK0001`` blob (magic + uint64 header length + sorted-JSON
manifest + raw K/V bytes, one block after another in chain order) is
published through the ordinary feeder/controller path as a raw ``uint8``
volume whose id is derived from the chain's deepest hash. The bytes are the
JAX package's for the same blocks, so a chain exported by either package is
adopted by the other:

* the HOLDER replica exports a chain once (a snapshot on the engine thread
  through its command queue, a pack, a publish); the prefill tier does so
  at every retirement (``ServeEngine.set_handoff_export``);
* a PEER that misses the prefix locally reads the volume back and writes
  the finished pages into its own pool (``ServeEngine(kv_fetch=...)``):
  adoption costs one volume read, not a prefill forward.

ANY defect (missing volume, fingerprint or chain mismatch, truncated blob)
is a miss or an error, and the engine recomputes locally: never a
misaligned resume.

Each side has a core that needs neither grpc nor protobuf, so the card's
path runs it without the control plane's wire: ``export_chain_to`` hands
the packed file to a ``publish(volume_id, path, total_bytes)`` callable, and
``ChainFetcher`` reads volumes through a ``read(volume_id)`` callable.
``export_chain`` and ``PeerPrefixFetcher`` are those cores over a
``Feeder``. bf16 blocks travel as their ``uint16`` bits in the port
(``serve/kvtier.py``); the export names them "bfloat16", the pool's dtype,
in the manifest, as JAX's does.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Callable, Sequence

import numpy as np
import torch

from oim_tpu_torch.common import events
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.controller.backend import dtype_name, read_window
from oim_tpu_torch.serve.weights import weights_request

_MAGIC = b"OIMK0001"

# Volume-id prefix of exported chains: the deepest hash names the whole
# chain (chain hashes are cumulative), so every replica that exports the
# same prefix publishes the SAME id and the controller's content
# addressing dedups the bytes.
VOLUME_PREFIX = "kvchain"


def _dtype_name(dtype) -> str:
    """The manifest's name of a numpy or torch dtype ("bfloat16" for
    torch's bf16, as JAX names it)."""
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return np.dtype(dtype).name


def _bits_dtype(name: str) -> np.dtype:
    """The numpy dtype a manifest's blocks are read as: bf16 as its
    ``uint16`` bits (numpy lacks bf16; the pool's writers reinterpret)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def config_fingerprint(cfg, page_tokens: int) -> dict:
    """The geometry a KV block's bytes depend on. Two engines whose
    fingerprints match hold interchangeable pages; a mismatch (other model,
    other page size) makes a fetched blob unusable and the unpack refuses
    it."""
    return {
        "n_layers": int(cfg.n_layers),
        "n_kv_heads": int(cfg.n_kv_heads),
        "head_dim": int(cfg.head_dim),
        "dtype": _dtype_name(cfg.dtype),
        "page_tokens": int(page_tokens),
    }


def chain_volume_id(hashes: Sequence[str]) -> str:
    """The content address of a chain's volume: the deepest hash commits to
    every token before it, so it names the whole chain."""
    if not hashes:
        raise ValueError("empty chain has no volume id")
    return f"{VOLUME_PREFIX}-{hashes[-1]}"


def pack_chain(hashes: Sequence[str], blocks, block: int, fingerprint: dict,
               dtype: str | None = None) -> bytes:
    """Serialize a chain's blocks (``blocks[i]`` is the (k, v) host arrays
    for ``hashes[i]``) into one self-describing blob, deterministic for a
    given chain. ``dtype`` names the blocks' dtype in the manifest; None
    names it from the arrays (pass the pool's for bf16 blocks held as
    ``uint16`` bits)."""
    if len(blocks) != len(hashes):
        raise ValueError(
            f"pack needs one block per hash: {len(hashes)} hashes, "
            f"{len(blocks)} blocks")
    if not hashes:
        raise ValueError("refusing to pack an empty chain")
    k0, v0 = (np.ascontiguousarray(a) for a in blocks[0])
    header = json.dumps({
        "chain": list(hashes),
        "block": int(block),
        "fingerprint": fingerprint,
        "k_shape": list(k0.shape),
        "v_shape": list(v0.shape),
        "dtype": dtype or _dtype_name(k0.dtype),
        "block_bytes": int(k0.nbytes + v0.nbytes),
        "total_bytes": int((k0.nbytes + v0.nbytes) * len(blocks)),
    }, sort_keys=True).encode()
    parts = [_MAGIC, struct.pack("<Q", len(header)), header]
    for k, v in blocks:
        k, v = np.ascontiguousarray(k), np.ascontiguousarray(v)
        if k.shape != k0.shape or v.shape != v0.shape:
            raise ValueError("ragged chain blocks cannot pack")
        # uint8 views: a buffer of ml_dtypes' bf16 has no format a
        # memoryview accepts.
        parts += [k.reshape(-1).view(np.uint8), v.reshape(-1).view(np.uint8)]
    # One join: each block's bytes are copied once, into the blob.
    return b"".join(parts)


def unpack_chain(buf, fingerprint: dict | None = None):
    """(hashes, blocks, block tokens) from packed bytes or a uint8 view of
    them; each block's (k, v) are views of ``buf`` (bf16 as ``uint16``
    bits). Raises ``ValueError`` on ANY defect (bad magic, truncation, a
    fingerprint other than ``fingerprint``): the caller treats it as a fetch
    failure and recomputes."""
    if isinstance(buf, (bytes, bytearray, memoryview)):
        data = np.frombuffer(buf, dtype=np.uint8)
    else:
        data = np.asarray(buf)
        if data.dtype != np.uint8:
            data = data.view(np.uint8)
    data = data.reshape(-1)
    if data[:len(_MAGIC)].tobytes() != _MAGIC:
        raise ValueError("not a packed oim KV-chain blob (bad magic)")
    (hlen,) = struct.unpack("<Q", data[len(_MAGIC):len(_MAGIC) + 8].tobytes())
    body = len(_MAGIC) + 8
    header = json.loads(data[body:body + hlen].tobytes())
    if fingerprint is not None and header["fingerprint"] != fingerprint:
        raise ValueError(
            f"KV-chain fingerprint mismatch: blob packed for "
            f"{header['fingerprint']}, engine expects {fingerprint}")
    base = body + hlen
    if len(data) - base < header["total_bytes"]:
        raise ValueError(
            f"truncated KV-chain blob: {len(data) - base} payload bytes, "
            f"manifest claims {header['total_bytes']}")
    dtype = _bits_dtype(header["dtype"])
    k_shape, v_shape = tuple(header["k_shape"]), tuple(header["v_shape"])
    k_bytes = int(np.prod(k_shape)) * dtype.itemsize
    v_bytes = int(np.prod(v_shape)) * dtype.itemsize
    blocks, off = [], base
    for _ in header["chain"]:
        k = data[off:off + k_bytes].view(dtype).reshape(k_shape)
        off += k_bytes
        v = data[off:off + v_bytes].view(dtype).reshape(v_shape)
        off += v_bytes
        blocks.append((k, v))
    return list(header["chain"]), blocks, int(header["block"])


def chain_request(volume_id: str, path: str, total_bytes: int):
    """The MapVolumeRequest publishing a packed chain file as a raw uint8
    volume: ``weights_request``'s shape, so publish and prestage content-key
    identically on every replica (``weights_params`` gives the same volume
    as the grpc-free dataclasses a backend's ``stage`` takes)."""
    return weights_request(volume_id, path, total_bytes)


def export_chain_to(engine, hashes: Sequence[str],
                    publish: Callable[[str, str, int], int],
                    timeout: float = 60.0) -> str | None:
    """Export one cached chain from ``engine``: snapshot (on the engine
    thread, through its command queue), pack, write a temporary file and
    ``publish(volume_id, path, total_bytes)``, which returns the bytes
    published. The grpc-free core of ``export_chain``. Returns the volume
    id, or None when the chain is no longer fully cached (a best-effort
    export never races retirement into a partial blob)."""
    hashes = list(hashes)
    blocks = engine.snapshot_chain(hashes, timeout=timeout)
    if not blocks:
        return None
    fingerprint = config_fingerprint(engine.cfg, engine.page_tokens)
    blob = pack_chain(hashes, blocks, engine.prefix_block, fingerprint,
                      dtype=fingerprint["dtype"])
    del blocks
    volume_id = chain_volume_id(hashes)
    fd, path = tempfile.mkstemp(prefix="oim-kvchain-", suffix=".bin")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        published = int(publish(volume_id, path, len(blob)))
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    M.KVTIER_EXPORTS.inc()
    engine.note_exported(hashes[-1], volume_id)
    events.emit(events.KV_CHAIN_EXPORTED, volume=volume_id, blocks=len(hashes),
                bytes=published)
    from_context().info("exported KV chain volume", volume=volume_id,
                        blocks=len(hashes), bytes=published)
    return volume_id


def export_chain(engine, feeder, hashes: Sequence[str],
                 timeout: float = 60.0) -> str | None:
    """Export one cached chain from ``engine`` as a content-addressed volume
    through ``feeder`` (``export_chain_to`` publishing with
    ``chain_request``). Returns the volume id, or None when the chain is no
    longer fully cached."""
    def publish(volume_id: str, path: str, total_bytes: int) -> int:
        return feeder.publish(chain_request(volume_id, path, total_bytes),
                              timeout=timeout).bytes

    return export_chain_to(engine, hashes, publish, timeout=timeout)


def volume_bytes(array) -> np.ndarray:
    """A staged volume's array as host ``uint8`` bytes: a tensor on the card
    or the host (or a ``plane.Placed``) through ``read_window``, a numpy
    array (a JAX controller's) as its own bytes."""
    if isinstance(array, np.ndarray):
        return np.ascontiguousarray(array).view(np.uint8).reshape(-1)
    raw, _ = read_window(array, 0, 0)
    return raw


class ChainFetcher:
    """The engine's ``kv_fetch`` callback over ``read(volume_id)``, which
    returns the volume's bytes (a uint8 array) or None when there is no such
    volume: resolve which exported volume covers the request's chain, read
    it, validate it against ``fingerprint`` and the chain, and hand back the
    adoptable blocks.

    ``known`` is an optional callable returning the deepest hashes known
    exported fleet-wide (the heartbeat's ``prefix_volumes``); without it,
    ``scan`` probes every depth from the full chain down (a free lookup on a
    local controller) or, False, only the full chain (a remote probe of each
    depth would each pay a failed RPC).

    Contract with the engine: return the consecutive blocks extending the
    local match (possibly []), or None after a fetch that STARTED and
    failed; the engine emits the fallback event for None and recomputes
    either way."""

    def __init__(self, read: Callable[[str], np.ndarray | None], fingerprint: dict,
                 known=None, scan: bool = True):
        self.read = read
        self.fingerprint = fingerprint
        self.known = known
        self.scan = scan

    def _candidate_depths(self, chain: list[str], m: int) -> list[int]:
        depths = list(range(len(chain), m, -1))
        if self.known is not None:
            try:
                known = set(self.known())
            except Exception:  # noqa: BLE001 - advisory source only
                known = set()
            return [j for j in depths if chain[j - 1] in known]
        return depths if self.scan else depths[:1]

    def __call__(self, chain, m: int):
        chain = list(chain)
        try:
            for j in self._candidate_depths(chain, m):
                volume_id = chain_volume_id(chain[:j])
                raw = self.read(volume_id)
                if raw is None:
                    continue
                hashes, blocks, _ = unpack_chain(raw, self.fingerprint)
                if hashes != chain[:j]:
                    raise ValueError(
                        f"volume {volume_id} does not hold the chain it is "
                        f"addressed by")
                M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="hit").inc()
                return [(chain[i], blocks[i]) for i in range(m, j)]
        except Exception as err:  # noqa: BLE001 - any defect => recompute
            M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="error").inc()
            from_context().warning("peer prefix fetch failed; recomputing locally",
                                   error=repr(err))
            return None
        M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="miss").inc()
        return []


class PeerPrefixFetcher(ChainFetcher):
    """``ChainFetcher`` over a ``Feeder``: local mode reads the attached
    controller's volume (``controller.get_volume``; a miss is a dict lookup,
    so every depth is probed), remote mode one whole-volume window
    (``fetch_window``; only the full chain is probed)."""

    def __init__(self, feeder, fingerprint: dict, known=None, timeout: float = 10.0):
        self.feeder = feeder
        self.timeout = timeout
        super().__init__(self._read, fingerprint, known=known,
                         scan=feeder.controller is not None)

    def _read(self, volume_id: str):
        if self.feeder.controller is not None:
            volume = self.feeder.controller.get_volume(volume_id)
            return None if volume is None else volume_bytes(volume.array)
        raw, _, _ = self.feeder.fetch_window(volume_id, 0, 0, timeout=self.timeout)
        return raw
