"""Rematerialization (``jax.checkpoint`` in the JAX package): a layer's or
block's activations are recomputed in the backward pass instead of kept.

The JAX policies map onto torch's selective checkpointing by the aten ops
whose outputs are kept: "" and "nothing" keep none (plain recompute,
jax's ``nothing_saveable``), "dots" keeps every matmul's output
(``dots_saveable``), "dots_with_no_batch_dims" only those of unbatched
matmuls (``dots_with_no_batch_dims_saveable``).
"""

from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint as tcp

_aten = torch.ops.aten

SAVED_OPS = {
    "": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_with_no_batch_dims": (_aten.mm.default, _aten.addmm.default),
    "nothing": (),  # == plain remat, named for clarity
}


def check_policy(policy: str) -> None:
    if policy not in SAVED_OPS:
        raise ValueError(f"unknown remat_policy {policy!r} (choices: {sorted(SAVED_OPS)})")


def checkpoint(fn, *args, policy: str = ""):
    """``fn(*args)``, its activations recomputed in the backward pass but
    for the outputs ``policy`` keeps. The layers draw no random numbers,
    so no RNG state is stashed for the recompute."""
    check_policy(policy)
    kw = {}
    if SAVED_OPS[policy]:
        kw["context_fn"] = functools.partial(tcp.create_selective_checkpoint_contexts,
                                             list(SAVED_OPS[policy]))
    return tcp.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
