"""Weights made on the device from the run's seed, handed alike to the
program and to the reference. A family names its leaves and this draws
them (``draw``).

Every leaf in the model's dtype is a view into ONE flat buffer drawn by
one ``torch.randn`` call on the device, then scaled in place; the norm
weights are ones, and the float32 leaves (an MoE router) one draw each
from the same generator after it. So set-up makes no float32 copy of a
large leaf and takes a few large calls."""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def draw(shapes, ones, float32, dtype: str, seed: int, device) -> dict:
    """The param tree drawn from ``seed`` on ``device``: ``shapes``, the
    (path, shape, scale) of each leaf in ``dtype``, in draw order;
    ``ones``, the (path, shape) of each float32 leaf of ones; ``float32``,
    the (path, shape, scale) of each float32 leaf drawn after them."""
    device = torch.device(device)
    gen = _generator(seed, device)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, dtype=DTYPES[dtype], device=device)
    tree: dict = {}
    at = 0
    for path, shape, scale in shapes:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(scale)
        _put(tree, path, leaf)
        at += n
    for path, shape in ones:
        _put(tree, path, torch.ones(shape, dtype=torch.float32, device=device))
    for path, shape, scale in float32:
        leaf = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        _put(tree, path, leaf.mul_(scale))
    return tree
