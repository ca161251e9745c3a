"""Block-granular prompt-prefix hashing (``oim_tpu/common/prefixhash.py``,
copied): the content address shared by the serve engine's prefix KV cache
and the router's affinity pick. The hash strings are the JAX package's,
byte for byte: routers compare them across replicas of either package.

A prompt's token ids are cut into fixed-size blocks and hashed as a
CHAIN: block i's hash covers block i's tokens AND the previous block's
hash, so a chain hash names the entire prefix up to and including its
block — ``a`` and ``a+b`` produce the same hash for the ``a`` blocks and
diverge from the first differing block on. That is what lets the engine
share cached K/V between requests that open with the same system prompt
(vLLM/SGLang automatic-prefix-caching lineage), and what lets the router
recognize "replica r holds this request's prefix" by comparing the
request's chain hashes against the hashes each replica advertises in its
heartbeat row.

This module is deliberately torch-free and serve-free, and both sides
(engine and router) MUST hash identically or affinity herds to replicas
that then miss.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

# Hex chars kept per chain hash. 64 bits of sha256: collisions are
# negligible at any realistic cache population, and short hashes keep
# the heartbeat row (which advertises a handful of them) small.
HASH_CHARS = 16


def chain_hashes(tokens: Sequence[int], block: int) -> list[str]:
    """One hash per FULL block of ``tokens``: ``hashes[i]`` names the
    prefix ``tokens[:(i + 1) * block]``. A partial tail block gets no
    hash — prefix reuse is block-granular by design (a finer grain would
    multiply cache entries without multiplying reusable content)."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    hashes: list[str] = []
    prev = b""
    for i in range(len(tokens) // block):
        blk = tokens[i * block:(i + 1) * block]
        h = hashlib.sha256()
        h.update(prev)
        for t in blk:
            h.update(int(t).to_bytes(8, "little", signed=True))
        digest = h.hexdigest()[:HASH_CHARS]
        hashes.append(digest)
        prev = digest.encode()
    return hashes


def usable_hashes(tokens: Sequence[int], block: int) -> list[str]:
    """The chain hashes a LOOKUP may match: full blocks only, and capped
    so at least one prompt token is always left for the prefill to
    forward (the prefill's last-token logits seed the first output
    token; a fully-cached prompt would leave it nothing to compute).
    Both the engine's admission lookup and the router's affinity hash
    use this — they must agree on what counts as matchable."""
    hashes = chain_hashes(tokens, block)
    while hashes and len(hashes) * block > len(tokens) - 1:
        hashes.pop()
    return hashes
