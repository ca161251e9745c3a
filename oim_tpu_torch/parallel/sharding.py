"""Named sharding rules (``oim_tpu/parallel/sharding.py``): logical array
dimensions -> mesh axes.

Models name every parameter dimension with a logical name (``"batch"``,
``"embed"``, ``"heads"``, ...); a ``ShardingRules`` table maps each to a
mesh axis, a tuple of axes, or None (replicated). Changing DP to FSDP to
TP/SP is a rules change, not a model change. The tables are the JAX
package's, as data.

Where JAX places a global array with a ``NamedSharding`` and lets XLA
insert the collectives, the port keeps plain tensors: each rank holds its
local shard, and ``Sharding`` says which dims are split over which axes.
``shard`` cuts a full tensor (or numpy array) into this rank's piece;
``gather`` is its inverse, an ``all_gather`` for each split dim, whose
backward reduce-scatters, so a sharded weight gathered in the forward
pass gets its gradient summed over those axes and cut back to the shard.
DTensor is not used: the flash-attention autograd Functions and the
stacked-layer slicing (``llama.layer_params``) take plain tensors, and
each collective of the step is then one call that a reader can see.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.mesh import Mesh

# Logical dimension names used by the models.
BATCH = "batch"
SEQ = "sequence"
EMBED = "embed"
HEAD = "heads"
KV_HEAD = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
VOCAB = "vocab"
EXPERT = "expert"
CONV_IN = "conv_in"
CONV_OUT = "conv_out"
# The leading dim of a STACKED layer tree (models/llama.py loops over it).
# Unmapped under dp/fsdp/tp_sp (every rank holds all layers); mapped to the
# "pipe" mesh axis under PIPE_RULES.
LAYER = "layer"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical name -> mesh axis name (or tuple of axes, or None)."""

    rules: tuple[tuple[str, Any], ...]

    @classmethod
    def of(cls, **rules: Any) -> "ShardingRules":
        return cls(tuple(rules.items()))

    def axis_for(self, logical: str | None):
        if logical is None:
            return None
        for name, axis in self.rules:
            if name == logical:
                return axis
        return None

    def spec(self, logical_axes: tuple[str | None, ...]) -> tuple:
        """The PartitionSpec entries: one axis entry per dim."""
        return tuple(self.axis_for(a) for a in logical_axes)


# Pure data parallelism: only the batch is split.
DP_RULES = ShardingRules.of(**{BATCH: "data"})

# FSDP: batch split over (data, fsdp); parameters sharded over fsdp along
# their largest dimension (embed for transformers, conv_out for convnets).
FSDP_RULES = ShardingRules.of(
    **{
        BATCH: ("data", "fsdp"),
        EMBED: "fsdp",
        CONV_OUT: "fsdp",
    }
)

# Megatron-style tensor parallelism + sequence parallelism for long context:
# heads/mlp/vocab split over "model", the sequence dimension over "seq".
TP_SP_RULES = ShardingRules.of(
    **{
        BATCH: ("data", "fsdp"),
        SEQ: "seq",
        EMBED: "fsdp",
        HEAD: "model",
        KV_HEAD: "model",
        MLP: "model",
        VOCAB: "model",
        EXPERT: "expert",
    }
)

# GPipe pipeline parallelism: the stacked layer axis over "pipe", the batch
# over "data", embed/lm_head's vocab over "pipe" too.
PIPE_RULES = ShardingRules.of(
    **{
        BATCH: "data",
        LAYER: "pipe",
        VOCAB: "pipe",
    }
)


def _entry(e) -> tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axes split each dim of one array (outer axis first, as
    a PartitionSpec entry lists them); a dim past ``dims`` is whole."""

    dims: tuple[tuple[str, ...], ...]

    @property
    def axes(self) -> tuple[str, ...]:
        """Every mesh axis this array is split over."""
        return tuple(a for d in self.dims for a in d)

    def parts(self, mesh: Mesh, dim: int) -> tuple[int, int]:
        """(pieces, this rank's piece) along ``dim``."""
        n, idx = 1, 0
        for name in self.dims[dim]:
            axis = mesh.axis(name)
            n, idx = n * axis.size, idx * axis.size + axis.index
        return n, idx

    def shard(self, x, mesh: Mesh):
        """This rank's piece of the full array ``x`` (a tensor or numpy
        array; a view where slicing gives one)."""
        for dim in range(len(self.dims)):
            n, idx = self.parts(mesh, dim)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not divide "
                                 f"into {n} shards over {self.dims[dim]}")
            step = x.shape[dim] // n
            index = [slice(None)] * x.ndim
            index[dim] = slice(idx * step, (idx + 1) * step)
            x = x[tuple(index)]
        return x

    def gather(self, x: torch.Tensor, mesh: Mesh, keep: tuple[str, ...] = ()) -> torch.Tensor:
        """The full array from every rank's piece: all_gather over each
        split dim's axes, innermost axis first (an axis of size 1 splits
        nothing and is skipped, as XLA elides it). Differentiable; its
        backward reduce-scatters. The pieces of the axes in ``keep`` stay
        local (tensor parallelism computes on its ``model`` slice)."""
        for dim, names in enumerate(self.dims):
            for name in reversed(names):
                axis = mesh.axis(name)
                if axis.size > 1 and name not in keep:
                    x = collectives.all_gather(x, axis, gather_dim=dim)
        return x


def logical_sharding(mesh: Mesh, rules: ShardingRules, logical_axes) -> Sharding:
    """The Sharding of one array's logical axes. Raises ValueError, as a
    JAX NamedSharding does, for an axis the mesh lacks or one used twice."""
    spec = rules.spec(tuple(logical_axes))
    dims = tuple(_entry(e) for e in spec)
    seen: set[str] = set()
    for names in dims:
        for name in names:
            if name not in mesh.shape:
                raise ValueError(f"Resource axis: {name} of PartitionSpec{spec} is not "
                                 f"found in mesh: {mesh.axis_names}.")
            if name in seen:
                raise ValueError(f"A mesh axis may appear once in a spec: {spec}")
            seen.add(name)
    return Sharding(dims)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and of matching trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def param_shardings(mesh: Mesh, rules: ShardingRules, logical_axes):
    """Tree of Shardings from a tree of logical-axes tuples."""
    return tree_map(lambda axes: logical_sharding(mesh, rules, axes), logical_axes)


def shard_params(mesh: Mesh, rules: ShardingRules, params, logical_axes):
    """This rank's shard of every leaf of a full parameter tree (tensors or
    numpy arrays). ``logical_axes`` is a matching tree of tuples of logical
    dimension names (``models.llama.param_logical_axes``)."""
    shardings = param_shardings(mesh, rules, logical_axes)
    return tree_map(lambda p, s: s.shard(p, mesh), params, shardings)


def rank_params(params, logical_axes, rules: ShardingRules, axes, rank: int):
    """Rank ``rank``'s pieces of a full parameter tree (tensors, as
    ``llama.from_numpy`` gives them, or numpy arrays) under ``rules`` over a
    mesh of ``axes`` (ranks in row-major order), computed without a
    process group: what ``shard_params`` gives that rank."""
    n = int(np.prod([s for _, s in axes])) if axes else 1
    return shard_params(Mesh(axes, range(n), "cpu", rank=rank), rules, params, logical_axes)


def gather_params(mesh: Mesh, shardings, params, keep: tuple[str, ...] = ()):
    """The full tree from every rank's shards (the inverse of
    ``shard_params``); differentiable. Pieces split over the axes in
    ``keep`` stay this rank's."""
    return tree_map(lambda p, s: s.gather(p, mesh, keep), params, shardings)


def shard_batch(mesh: Mesh, rules: ShardingRules, batch, logical_axes=None):
    """This rank's rows of a global batch: the leading dim split over the
    BATCH axes, the rest whole (or as ``logical_axes`` names them)."""

    def cut(x, axes=None):
        if axes is None:
            axes = (BATCH,) + (None,) * (np.ndim(x) - 1)
        return logical_sharding(mesh, rules, axes).shard(x, mesh)

    if logical_axes is not None:
        return {k: cut(v, logical_axes[k]) for k, v in batch.items()}
    return {k: cut(v) for k, v in batch.items()}
