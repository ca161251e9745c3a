"""ResNet-50 v1.5 (``oim_tpu/models/resnet.py``).

The param tree keeps the JAX package's keys, so weights carry across with
``from_numpy``/``to_numpy``. Conv kernels arrive HWIO and are held OIHW in
``torch.channels_last`` memory; images arrive NHWC, and
``x.permute(0, 3, 1, 2)`` is already a channels_last NCHW view, so cuDNN
runs its NHWC kernels with no layout copy. bf16 activations and weights,
f32 batch-norm statistics, logits in f32.

Three details of XLA that torch does differently, kept here:

* "SAME" padding is asymmetric at stride 2 on even sizes (XLA puts the
  odd pad at the end: (2, 3) for the 7x7/2 stem, (0, 1) for a 3x3/2 conv
  and the 3x3/2 max-pool); torch's ``padding=`` is symmetric, so the pads
  are applied with ``F.pad`` where they differ.
* Batch norm is the JAX ``_batchnorm``: one-pass f32 statistics with the
  biased variance, running statistics as ``momentum * old + (1 -
  momentum) * new`` (momentum 0.9), and the normalization folded into a
  per-channel ``x * a + b`` in x's dtype. ``nn.BatchNorm2d`` differs in
  each.
* ``apply`` is functional: training mode returns the new BN state and
  never updates a buffer in place, so a recomputed block (remat) cannot
  update the running statistics twice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from oim_tpu_torch.common.device import require
from oim_tpu_torch.models import remat as rematlib

STAGES = (3, 4, 6, 3)  # ResNet-50 bottleneck counts
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class Config:
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # Recompute each bottleneck's activations in the backward pass.
    remat: bool = False
    # Space-to-depth stem: the 7x7/2 conv over 3 channels as the equivalent
    # 4x4/1 conv over the 2x2-blocked 12-channel input, folded at apply
    # time from the same [7,7,3,64] parameters.
    stem_s2d: bool = False


def _conv_init(rng, kh, kw, cin, cout, dtype, device):
    std = (2.0 / (kh * kw * cin)) ** 0.5
    w = torch.randn((cout, cin, kh, kw), generator=rng, dtype=torch.float32,
                    device=rng.device) * std
    return w.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _bn_params(c, device):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def _bn_state(c, device):
    return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def init(rng: torch.Generator, cfg: Config = Config(), device="cuda"):
    """Returns (params, bn_state) on ``device``, drawn from ``rng`` on its
    own device. The draws differ from ``jax.random``'s; carry JAX weights
    across with ``from_numpy`` to compare the two packages."""
    device = require(device)
    params: dict = {"stem": _conv_init(rng, 7, 7, 3, cfg.width, cfg.dtype, device),
                    "bn_stem": _bn_params(cfg.width, device)}
    state: dict = {"bn_stem": _bn_state(cfg.width, device)}
    cin = cfg.width
    for s, (n_blocks, w) in enumerate(zip(STAGES, STAGE_WIDTHS)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            cout = w * EXPANSION
            block = {
                "conv1": _conv_init(rng, 1, 1, cin, w, cfg.dtype, device),
                "bn1": _bn_params(w, device),
                "conv2": _conv_init(rng, 3, 3, w, w, cfg.dtype, device),
                "bn2": _bn_params(w, device),
                "conv3": _conv_init(rng, 1, 1, w, cout, cfg.dtype, device),
                "bn3": _bn_params(cout, device),
            }
            bstate = {"bn1": _bn_state(w, device), "bn2": _bn_state(w, device),
                      "bn3": _bn_state(cout, device)}
            if stride != 1 or cin != cout:
                block["proj"] = _conv_init(rng, 1, 1, cin, cout, cfg.dtype, device)
                block["bn_proj"] = _bn_params(cout, device)
                bstate["bn_proj"] = _bn_state(cout, device)
            params[f"stage{s}_block{b}"] = block
            state[f"stage{s}_block{b}"] = bstate
            cin = cout
    head = torch.randn((cin, cfg.num_classes), generator=rng, dtype=torch.float32,
                       device=rng.device) * cin ** -0.5
    params["head"] = {"kernel": head.to(device=device, dtype=cfg.dtype),
                      "bias": torch.zeros(cfg.num_classes, device=device)}
    return params, state


def _batchnorm(x, p, s, training, momentum, eps):
    """f32 statistics over (N, H, W) of NCHW x; x's dtype in and out."""
    if training:
        xf = x.float()
        n = xf.numel() // xf.shape[1]
        m1 = torch.sum(xf, dim=(0, 2, 3)) / n
        m2 = torch.sum(xf * xf, dim=(0, 2, 3)) / n
        mean = m1
        var = torch.clamp(m2 - m1 * m1, min=0.0)
        # The running statistics carry no gradient (JAX returns them as
        # the loss's auxiliary output).
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["scale"]  # [C] f32
    a = inv.to(x.dtype)[None, :, None, None]
    b = (p["bias"] - mean * inv).to(x.dtype)[None, :, None, None]
    return x * a + b, new_s


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" (lo, hi) padding of one spatial dim: the odd pad at
    the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    """(x padded where the SAME pads are asymmetric, symmetric pads left
    for the op itself)."""
    ph, pw = same_pads(x.shape[2], kh, stride), same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def conv_same(x, w, stride: int = 1):
    """lax.conv_general_dilated with "SAME" padding, NCHW x, OIHW w."""
    x, pad = _pad_same(x, w.shape[2], w.shape[3], stride)
    return F.conv2d(x, w, stride=stride, padding=pad)


def max_pool_same(x, k: int = 3, stride: int = 2):
    """lax.reduce_window(max, -inf) over k x k with "SAME" padding."""
    x, pad = _pad_same(x, k, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=pad)


def _bottleneck(x, p, s, stride, training, momentum, eps):
    new_s = {}
    y, new_s["bn1"] = _batchnorm(conv_same(x, p["conv1"]), p["bn1"], s["bn1"],
                                 training, momentum, eps)
    y = F.relu(y)
    y, new_s["bn2"] = _batchnorm(conv_same(y, p["conv2"], stride), p["bn2"], s["bn2"],
                                 training, momentum, eps)
    y = F.relu(y)
    y, new_s["bn3"] = _batchnorm(conv_same(y, p["conv3"]), p["bn3"], s["bn3"],
                                 training, momentum, eps)
    if "proj" in p:
        x, new_s["bn_proj"] = _batchnorm(conv_same(x, p["proj"], stride), p["bn_proj"],
                                         s["bn_proj"], training, momentum, eps)
    return F.relu(y + x), new_s


def _space_to_depth(x):
    """NHWC [N, H, W, C] -> [N, H/2, W/2, 4C] with channel order (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def _fold_stem_kernel(k):
    """OIHW [Cout, Cin, 7, 7] stride-2 kernel -> the equivalent OIHW
    [Cout, 4Cin, 4, 4] stride-1 kernel over the space-to-depth input (the
    JAX package's fold, done on the HWIO view)."""
    hwio = k.permute(2, 3, 1, 0)
    kh, kw, cin, cout = hwio.shape
    kp = F.pad(hwio, (0, 0, 0, 0, 0, 8 - kw, 0, 8 - kh))
    kp = kp.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return (kp.reshape(4, 4, 4 * cin, cout).permute(3, 2, 0, 1)
            .contiguous(memory_format=torch.channels_last))


def apply(params, state, images, cfg: Config = Config(), training: bool = False):
    """images: [N, H, W, 3], float in [0, 1] or uint8 (normalized here, on
    the device). Returns (logits_f32, new_state)."""
    if images.dtype == torch.uint8:
        x = images.to(cfg.dtype) / 255.0
    else:
        x = images.to(cfg.dtype)
    new_state: dict = {}
    if cfg.stem_s2d:
        x = _space_to_depth(x).permute(0, 3, 1, 2)
        x = F.conv2d(F.pad(x, (1, 2, 1, 2)), _fold_stem_kernel(params["stem"]))
    else:
        x = conv_same(x.permute(0, 3, 1, 2), params["stem"], stride=2)
    x, new_state["bn_stem"] = _batchnorm(x, params["bn_stem"], state["bn_stem"], training,
                                         cfg.bn_momentum, cfg.bn_eps)
    x = max_pool_same(F.relu(x))
    for s_idx, n_blocks in enumerate(STAGES):
        for b in range(n_blocks):
            name = f"stage{s_idx}_block{b}"
            stride = 2 if (b == 0 and s_idx > 0) else 1

            def block_fn(x, p, s, _stride=stride):
                return _bottleneck(x, p, s, _stride, training, cfg.bn_momentum, cfg.bn_eps)

            if cfg.remat:
                x, new_state[name] = rematlib.checkpoint(block_fn, x, params[name],
                                                         state[name])
            else:
                x, new_state[name] = block_fn(x, params[name], state[name])
    x = torch.mean(x.float(), dim=(2, 3))  # global average pool
    logits = x @ params["head"]["kernel"].float() + params["head"]["bias"]
    return logits, new_state


def num_flops_per_image(image_size: int = 224) -> float:
    """Approximate forward-pass FLOPs (the standard ~4.1 GFLOPs at 224)."""
    return 4.1e9 * (image_size / 224.0) ** 2


def num_params(cfg: Config = Config()) -> int:
    """Trainable parameters (conv kernels, BN scale and bias, the head)."""
    total, cin = 7 * 7 * 3 * cfg.width + 2 * cfg.width, cfg.width
    for s, (n_blocks, w) in enumerate(zip(STAGES, STAGE_WIDTHS)):
        for b in range(n_blocks):
            cout = w * EXPANSION
            total += cin * w + 9 * w * w + w * cout + 2 * (2 * w + cout)
            if (b == 0 and s > 0) or cin != cout:
                total += cin * cout + 2 * cout
            cin = cout
    return total + cin * cfg.num_classes + cfg.num_classes


# ------------------------------------------------ weight carry-across ----


def from_numpy(tree, device="cuda", dtype=None) -> dict:
    """The JAX tree (params or BN state) as numpy arrays -> the port's,
    same keys. 4-D leaves are conv kernels: HWIO in, OIHW in channels_last
    memory out. bf16 leaves may arrive as ml_dtypes bfloat16 arrays or as
    ``uint16`` views of their bits. ``dtype`` casts every floating leaf."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree, copy=True, order="C")
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t.to(device)


def to_numpy(tree) -> dict:
    """The port's tree -> numpy arrays in the JAX layout (conv kernels
    HWIO), same keys; bf16 leaves come out as ``uint16`` views of their
    bits."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
