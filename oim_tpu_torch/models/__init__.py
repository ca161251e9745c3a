"""Models (``oim_tpu/models``): the llama family's dense path, and its
KV-cached decoding in ``models.generate``."""

from oim_tpu_torch.models import llama

__all__ = ["llama"]
