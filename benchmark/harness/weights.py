"""Weights made on the device from the run's seed, in the port's param
tree (stacked [L, ...] layer leaves, an MoE model's under
``layers["moe"]``), handed alike to the program and to the reference.

Every bf16 leaf is a view into ONE flat buffer drawn by one
``torch.randn`` call on the device, then scaled in place (the port's init
scales: 0.02 for the embedding, fan-in for the projections); the MoE
router is one float32 draw, the norm weights ones. So set-up makes no
float32 copy of a large leaf and takes a few large calls."""

from __future__ import annotations

import math

import torch

from benchmark.harness.model import Dims

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def leaf_shapes(d: Dims) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, scale) of each model-dtype leaf, in draw order."""
    L, D = d.n_layers, d.dim
    leaves = [
        (("embed",), (d.vocab, D), 0.02),
        (("layers", "wq"), (L, D, d.q_dim), D ** -0.5),
        (("layers", "wk"), (L, D, d.kv_dim), D ** -0.5),
        (("layers", "wv"), (L, D, d.kv_dim), D ** -0.5),
        (("layers", "wo"), (L, d.q_dim, D), d.q_dim ** -0.5),
    ]
    if d.n_experts:
        E = d.n_experts
        leaves += [
            (("layers", "moe", "w_gate"), (L, E, D, d.mlp_dim), D ** -0.5),
            (("layers", "moe", "w_up"), (L, E, D, d.mlp_dim), D ** -0.5),
            (("layers", "moe", "w_down"), (L, E, d.mlp_dim, D), d.mlp_dim ** -0.5),
        ]
    else:
        leaves += [
            (("layers", "w_gate"), (L, D, d.mlp_dim), D ** -0.5),
            (("layers", "w_up"), (L, D, d.mlp_dim), D ** -0.5),
            (("layers", "w_down"), (L, d.mlp_dim, D), d.mlp_dim ** -0.5),
        ]
    leaves.append((("lm_head",), (D, d.vocab), D ** -0.5))
    return leaves


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_params(d: Dims, seed: int, device) -> dict:
    """The param tree of ``d`` drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    dtype = DTYPES[d.dtype]
    gen = _generator(seed, device)
    shapes = leaf_shapes(d)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    at = 0
    for path, shape, scale in shapes:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(scale)
        _put(tree, path, leaf)
        at += n
    L, D = d.n_layers, d.dim
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    _put(tree, ("layers", "attn_norm"), ones(L, D))
    _put(tree, ("layers", "mlp_norm"), ones(L, D))
    _put(tree, ("final_norm",), ones(D))
    if d.n_experts:
        router = torch.randn((L, D, d.n_experts), generator=gen, dtype=torch.float32,
                             device=device)
        _put(tree, ("layers", "moe", "router"), router.mul_(D ** -0.5))
    return tree


def count_params(d: Dims, active: bool = False) -> int:
    """Parameters of ``d`` (``active``: a token's top-k experts only)."""
    L, D = d.n_layers, d.dim
    attn = D * d.q_dim + 2 * D * d.kv_dim + d.q_dim * D + 2 * D
    experts = (d.top_k if active else d.n_experts) if d.n_experts else 1
    ffn = 3 * experts * D * d.mlp_dim + (D * d.n_experts if d.n_experts else 0)
    return 2 * d.vocab * D + L * (attn + ffn) + D
