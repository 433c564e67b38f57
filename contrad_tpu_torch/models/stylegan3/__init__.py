"""StyleGAN3-T model family (``generator.py``); its discriminator is
StyleGAN2's (``models/stylegan2``)."""

from contrad_tpu_torch.models.stylegan3.generator import (
    GStylegan3, synthesis_schedule)

__all__ = ["GStylegan3", "synthesis_schedule"]
