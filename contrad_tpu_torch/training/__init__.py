"""Losses, penalties, modes, optimiser and the train steps of the port."""

from contrad_tpu_torch.training.state import ScheduledAdam, ema_update
from contrad_tpu_torch.training.step import GANTrainer, StyleGAN2Trainer

__all__ = ["GANTrainer", "ScheduledAdam", "StyleGAN2Trainer", "ema_update"]
