"""StyleGAN2 model family (the port of ``contrad_tpu/models/stylegan2``)."""

from contrad_tpu_torch.models.stylegan2.discriminator import (
    DStylegan2, minibatch_stddev)
from contrad_tpu_torch.models.stylegan2.generator import (
    GStylegan2, ModulatedConv, stylegan2_channels)

__all__ = ["GStylegan2", "DStylegan2", "ModulatedConv", "minibatch_stddev",
           "stylegan2_channels"]
