"""Models (``oim_tpu/models``): the llama family's dense path."""

from oim_tpu_torch.models import llama

__all__ = ["llama"]
