"""Host-side image augmentation for the training feed
(``oim_tpu/data/augment.py``, numpy, kept as it is): the same
``RandomState`` stream gives the same images.

Runs on the host inside the input pipeline, so the train step stays
deterministic: random horizontal flip + random crop from a reflect-padded
canvas.
"""

from __future__ import annotations

import numpy as np


def augment_images(
    images: np.ndarray,
    rng: np.random.RandomState,
    crop_pad: int = 4,
    flip: bool = True,
) -> np.ndarray:
    """[N, H, W, C] -> augmented [N, H, W, C] (same dtype).

    Per sample: 50% horizontal flip, then a random H x W crop from the
    image reflect-padded by ``crop_pad`` on each spatial edge.
    """
    n, h, w, _ = images.shape
    out = images
    if flip:
        mask = rng.rand(n) < 0.5
        out = np.where(mask[:, None, None, None], out[:, :, ::-1], out)
    if crop_pad:
        padded = np.pad(
            out,
            ((0, 0), (crop_pad, crop_pad), (crop_pad, crop_pad), (0, 0)),
            mode="reflect",
        )
        ys = rng.randint(0, 2 * crop_pad + 1, n)
        xs = rng.randint(0, 2 * crop_pad + 1, n)
        out = np.stack([
            padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w] for i in range(n)
        ])
    return out


def augment_batches(batches, seed: int = 0, crop_pad: int = 4):
    """Wrap a batch iterator, augmenting every "images" entry."""
    rng = np.random.RandomState(seed)
    for batch in batches:
        if "images" in batch:
            batch = dict(
                batch, images=augment_images(batch["images"], rng, crop_pad)
            )
        yield batch
