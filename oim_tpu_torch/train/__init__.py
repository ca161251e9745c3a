"""Training (``oim_tpu/train``): single-device train step and loop."""

from oim_tpu_torch.train.state import TrainState, make_optimizer
from oim_tpu_torch.train.trainer import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "TrainState", "Trainer", "make_optimizer", "make_train_step"]
