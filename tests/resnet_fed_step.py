"""ResNet-50 trainer steps on fed images in both packages, against the
f64 truth: the helpers of ``tests/test_torch_feeds_volumes.py``'s ResNet
case, and the measurement of how far each package's f32 steps lie from
that truth over several image sets.

The truth is JAX's f64 evaluation of the same steps from the same
weights: x64 on, and the f32 casts of the JAX model, loss and trainer
made f64 ones (as ``tests/test_torch_resnet.py``'s gradient test does).
The port's f64 evaluation turns ``Tensor.float`` into ``double``.

    JAX_PLATFORMS=cpu python -m tests.resnet_fed_step --seeds 5

prints, for each seed's images, the relative distance of every step's
loss and grad norm from the truth: the port's f64 steps, the port's f32
steps and JAX's f32 steps.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oim_tpu.data import readers as jreaders
from oim_tpu.models import resnet as jresnet
from oim_tpu.ops import losses as jlosses
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.models import resnet as tresnet
from oim_tpu_torch.train import trainer as ttrainer

# Three steps: step 1 runs at lr 0 (the first warmup step), step 2 at
# lr > 0, so step 3's loss and grad norm read step 2's update.
STEPS, BATCH, SIZE, CLASSES = 3, 8, 64, 5
KW = dict(model="resnet50", batch_size=BATCH, image_size=SIZE, num_classes=CLASSES,
          warmup_steps=2, total_steps=6, lr=1e-3, log_every=1, seed=2)


def texture_jpegs(n: int, seed: int, size: int = SIZE) -> list[bytes]:
    """JPEGs of random texture at the model's own size: 8x8 blocks of a
    random colour under per-pixel noise, so no image is a smooth
    upsampling and every batch norm sees spread in space and batch."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        blocks = rng.randint(0, 256, (size // 8, size // 8, 3)).astype(np.float32)
        im = np.kron(blocks, np.ones((8, 8, 1), np.float32)) * 0.5
        im = np.clip(im + rng.randint(0, 128, (size, size, 3)), 0, 255).astype(np.uint8)
        out.append(jreaders.encode_jpeg(im, quality=90))
    return out


class _JnpF64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def f64_everywhere():
    """x64 on, the JAX model's, loss's and trainer's f32 casts made f64
    ones, and the port's ``Tensor.float`` made ``double``."""
    saved = [(m, m.jnp) for m in (jresnet, jlosses, jtrainer)]
    x64, as_float = jax.config.jax_enable_x64, torch.Tensor.float
    jax.config.update("jax_enable_x64", True)
    for m, _ in saved:
        m.jnp = _JnpF64()
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = as_float
        for m, orig in saved:
            m.jnp = orig
        jax.config.update("jax_enable_x64", x64)


def jax_initial():
    """The JAX trainer's initial (params, BN state) in f32, as numpy."""
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**KW, model_overrides={"dtype": jnp.float32}),
                          axes=[("data", 1)])
    jt.init_or_resume()
    return jax.tree.map(np.asarray, (jt.state.params, jt.state.extra))


def jax_steps(batches: list[dict], init, f64: bool = False) -> list[tuple[float, float]]:
    """(loss, grad norm) of each of JAX's trainer steps from ``init``; in
    f64 under ``f64_everywhere``."""
    dtype = jnp.float64 if f64 else jnp.float32
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**KW, model_overrides={"dtype": dtype}),
                          axes=[("data", 1)])
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
    jt.state = jtrainer.TrainState.create(cast(init[0]), jt.tx, cast(init[1]))
    out = []
    for b in batches:
        jt.state, stats = jt.step_fn(jt.state, jt.place_batch(b))
        out.append((float(stats["loss"]), float(stats["grad_norm"])))
    return out


def _as(tree, dtype):
    if isinstance(tree, dict):
        return {k: _as(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def port_steps(batches: list[dict], init, dtype=torch.float32) -> list[tuple[float, float]]:
    """(loss, grad norm) of each of the port's trainer steps from ``init``."""
    tt = ttrainer.Trainer(ttrainer.TrainConfig(**KW, model_overrides={"dtype": dtype}),
                          device="cpu")
    tt.init(_as(tresnet.from_numpy(init[0], device="cpu"), dtype),
            _as(tresnet.from_numpy(init[1], device="cpu"), dtype))
    tt.run(steps=len(batches), data=iter(batches))
    return [(r["loss"], r["grad_norm"]) for r in tt.history if "loss" in r]


def rel(got, truth) -> list[list[float]]:
    """|got - truth| / |truth| of each step's loss and grad norm."""
    return [[abs(g - t) / abs(t) for g, t in zip(gs, ts)] for gs, ts in zip(got, truth)]


def spread(batches: list[dict], init) -> dict:
    """Every evaluation's distance from the truth on ``batches``."""
    jf32 = jax_steps(batches, init)
    pf32 = port_steps(batches, init)
    with f64_everywhere():
        truth = jax_steps(batches, init, f64=True)
        pf64 = port_steps(batches, init, torch.float64)
    return {"truth": truth, "port_f64": rel(pf64, truth), "port_f32": rel(pf32, truth),
            "jax_f32": rel(jf32, truth), "port_f32_vs_jax_f32": rel(pf32, jf32)}


def main() -> int:
    from oim_tpu.data import feeds as jfeeds

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    torch.set_num_threads(4)
    init = jax_initial()
    cfg = jtrainer.TrainConfig(**KW)
    for seed in range(args.seeds):
        images = np.stack(jfeeds._decode_images(texture_jpegs(STEPS * BATCH, seed), cfg))
        labels = np.arange(STEPS * BATCH, dtype=np.int32) % CLASSES
        batches = [{"images": images[i * BATCH:(i + 1) * BATCH],
                    "labels": labels[i * BATCH:(i + 1) * BATCH]} for i in range(STEPS)]
        print(json.dumps({"seed": seed, **spread(batches, init)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
