"""Layer ops (``oim_tpu/ops``): plain torch, except attention, whose flash
forward and backward run as hand-written Hopper kernels on CUDA tensors
(``oim_tpu_torch/kernels``)."""

from oim_tpu_torch.ops.attention import (
    attention,
    attention_with_lse,
    flash_attention,
    flash_attention_lse,
    mha_reference,
    ref_attention_lse,
)
from oim_tpu_torch.ops.losses import (
    accuracy,
    chunked_softmax_cross_entropy,
    softmax_cross_entropy,
)
from oim_tpu_torch.ops.norms import layernorm, rmsnorm
from oim_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "accuracy",
    "apply_rope",
    "attention",
    "attention_with_lse",
    "chunked_softmax_cross_entropy",
    "flash_attention",
    "flash_attention_lse",
    "layernorm",
    "mha_reference",
    "ref_attention_lse",
    "rmsnorm",
    "rope_frequencies",
    "softmax_cross_entropy",
]
