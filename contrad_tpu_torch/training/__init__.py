"""Losses, modes, optimiser and the StyleGAN2 train step of the port."""

from contrad_tpu_torch.training.state import ScheduledAdam, ema_update
from contrad_tpu_torch.training.step import StyleGAN2Trainer

__all__ = ["ScheduledAdam", "StyleGAN2Trainer", "ema_update"]
