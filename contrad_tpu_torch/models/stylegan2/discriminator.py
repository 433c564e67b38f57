"""StyleGAN2 discriminator (the port of
``contrad_tpu/models/stylegan2/discriminator.py``): ResidualDiscriminatorP,
FromRGB -> residual downsample blocks (/sqrt(2)) -> minibatch stddev ->
3x3 conv -> flattened penultimate features, wrapped with the three heads of
:class:`contrad_tpu_torch.models.base.Discriminator`. No spectral norm.
Under a bfloat16 compute dtype (``dtype``) the input ``x * 2 - 1`` is cast
to it and the layers follow; the minibatch stddev is taken in float32 and
cast back, and the features reach the heads in float32
(``contrad_tpu/models/stylegan2/discriminator.py:40-151``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from contrad_tpu_torch import at_least_f32, cast
from contrad_tpu_torch.models.base import Discriminator
from contrad_tpu_torch.models.stylegan2.generator import stylegan2_channels
from contrad_tpu_torch.models.stylegan2.layers import ConvLayer, FromRGB
from contrad_tpu_torch.parallel import data_shard


def stddev_group_size(rows: int, world: int, stddev_group: int = 4) -> int:
    """The minibatch-stddev group of a D pass over ``rows`` rows a rank in
    a world of ``world`` processes: ``min(N, stddev_group)`` of the global
    N = ``rows * world``, as the JAX package takes it over its global batch.
    Its groups are contiguous, so they stay on one rank where ``rows`` is a
    multiple of the group; otherwise a ValueError naming the batch and the
    world."""
    group = min(rows * world, stddev_group)
    if rows % group:
        raise ValueError(
            f"minibatch stddev: a global batch of {rows * world} on {world} "
            f"processes leaves {rows} rows a rank, not a multiple of the "
            f"stddev group {group}")
    return group


def minibatch_stddev(x: torch.Tensor, stddev_group: int = 4) -> torch.Tensor:
    """Append a per-group feature-stddev channel, groups of contiguous
    samples as in the JAX package (reference discriminator.py:22-33). In a
    world the group size is that of the global batch and every group lies
    on one rank (:func:`stddev_group_size`)."""
    n, h, w, c = x.shape
    world = data_shard()[1]
    group = (min(n, stddev_group) if world == 1
             else stddev_group_size(n, world, stddev_group))
    g = at_least_f32(x).reshape(n // group, group, h, w, c)
    std = torch.sqrt(torch.var(g, dim=1, unbiased=False) + 1e-8)
    std = std.mean(dim=(1, 2, 3)).to(x.dtype)  # (n // group,)
    std = std.repeat_interleave(group)[:, None, None, None].expand(n, h, w, 1)
    return torch.cat([x, std], dim=-1)


class ResBlock(nn.Module):
    """conv3x3 + blur-downsample conv3x3, 1x1 blur-downsample skip, /sqrt(2)
    (reference discriminator.py:60-76)."""

    def __init__(self, in_ch: int, features: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, activate=True)
        self.conv2 = ConvLayer(in_ch, features, 3, blur_kernel=blur_kernel,
                               downsample=True, activate=True)
        self.skip = ConvLayer(in_ch, features, 1, blur_kernel=blur_kernel,
                              downsample=True, activate=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2.0)


class ResidualBackbone(nn.Module):
    """FromRGB -> ResBlocks -> minibatch stddev -> 3x3 conv -> flatten
    (reference discriminator.py:191-235). Blocks are named ``block_<res>``
    as in the JAX parameter tree."""

    def __init__(self, size: int, channel_multiplier: float = 2.0,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 small32: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        channels = stylegan2_channels(channel_multiplier, small32)
        self.from_rgb = FromRGB(channels[size])
        self.block_names = []
        for i in range(int(math.log2(size)), 2, -1):
            name = f"block_{2**i}"
            self.add_module(name, ResBlock(channels[2**i],
                                           channels[2 ** (i - 1)],
                                           blur_kernel))
            self.block_names.append(name)
        self.last_conv = ConvLayer(channels[4] + 1, channels[4], 3,
                                   activate=True)

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        """``train`` and ``persist`` are the Discriminator protocol's; this
        backbone has no spectral norm and no state, so both are no-ops."""
        x = self.from_rgb(cast(x * 2.0 - 1.0, self.dtype))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.last_conv(minibatch_stddev(x))
        return at_least_f32(x.reshape(x.shape[0], -1))  # NHWC flatten, as JAX


def DStylegan2(size: int, channel_multiplier: float = 2.0,
               blur_kernel: Sequence[int] = (1, 3, 3, 1),
               small32: bool = False, d_hidden: int = 128,
               n_classes: int = 1, dtype: Optional[torch.dtype] = None
               ) -> Discriminator:
    channels = stylegan2_channels(channel_multiplier, small32)
    return Discriminator(
        backbone=ResidualBackbone(size, channel_multiplier, blur_kernel,
                                  small32, dtype),
        d_penul=channels[4] * 4 * 4, d_hidden=d_hidden, n_classes=n_classes)
