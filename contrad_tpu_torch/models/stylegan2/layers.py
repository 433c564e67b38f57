"""StyleGAN2 building-block layers (the port of
``contrad_tpu/models/stylegan2/layers.py``).

Equalised-learning-rate layers keep their RAW parameters (N(0,1), divided by
lr_mul) and apply the runtime scale ``lr_mul / sqrt(fan_in)`` in the forward,
as the JAX package does: Adam's step depends on the parameter's scale, so
pre-scaled weights would train differently. Activations are NHWC; conv
weights are OIHW. A conv permutes its NHWC input to an NCHW view, which is
``channels_last`` in memory, so no copy is made.

The downsampling ConvLayer takes the reference's unfused form, Blur then a
stride-2 conv, which puts the blur kernel on the main path (the JAX default
folds the blur into the conv, ``compose_blur_kernel``; same function).

The layers have no dtype of their own: weights, biases and FIR taps are
cast to the input's dtype, so a bfloat16 activation stays bfloat16 and
reaches the blur kernel so (``contrad_tpu/models/stylegan2/layers.py:40-110``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch.ops.blur import blur2d
from contrad_tpu_torch.ops.fused_act import FusedLeakyReLU, fused_leaky_relu
from contrad_tpu_torch.ops.upfirdn2d import blur_taps, make_kernel


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(mean(x^2) + 1e-8) over features (reference layers.py:15-20)."""
    return x * torch.rsqrt(torch.mean(x**2, dim=-1, keepdim=True) + 1e-8)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """NHWC in, NHWC out; ``weight`` OIHW."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class EqualDense(nn.Module):
    """EqualLinear (reference layers.py:132-159): weight ~ N(0, 1/lr_mul),
    runtime scale (1/sqrt(in))*lr_mul, bias*lr_mul + bias_init, optional
    fused leaky-relu. ``weight`` is (out, in)."""

    def __init__(self, in_dim: int, features: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(features, in_dim) / lr_mul)
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.bias_init = bias_init
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = (self.bias * self.lr_mul + self.bias_init).to(x.dtype)
        y = F.linear(x, (self.weight * self.scale).to(x.dtype))
        if self.activation:
            return fused_leaky_relu(y, b)
        return y + b


class EqualConv(nn.Module):
    """EqualConv2d (reference layers.py:95-129): weight ~ N(0,1), runtime
    scale 1/sqrt(fan_in)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn(features, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x, (self.weight * self.scale).to(x.dtype),
                        self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Blur(nn.Module):
    """FIR blur with zero padding ``pad`` on both spatial dims, through the
    hand-written blur kernel."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1),
                 pad: Tuple[int, int] = (0, 0), upsample_factor: int = 1):
        super().__init__()
        self.taps_v, self.taps_h = blur_taps(make_kernel(kernel),
                                             upsample_factor)
        self.pad = tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur2d(x, self.taps_v, self.taps_h, self.pad)


class Downsample(nn.Module):
    """``downsample2d``: the FIR blur with pads ``((p + 1) // 2, p // 2)``,
    ``p = len(kernel) - factor``, through the blur kernel, then every
    ``factor``-th row and column
    (``contrad_tpu/models/stylegan2/layers.py:124-130``)."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        p = len(kernel) - factor
        self.blur = Blur(kernel, pad=((p + 1) // 2, p // 2))
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blur(x)[:, ::self.factor, ::self.factor]


class ConvLayer(nn.Module):
    """[Blur +] EqualConv [+ FusedLeakyReLU]; downsample = blur, then a
    stride-2 conv (reference layers.py:174-199)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 downsample: bool = False, activate: bool = True):
        super().__init__()
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur = Blur(blur_kernel, pad=((p + 1) // 2, p // 2))
            stride, padding = 2, 0
        else:
            self.blur = None
            stride, padding = 1, kernel_size // 2
        self.conv = EqualConv(in_ch, features, kernel_size, stride=stride,
                              padding=padding, use_bias=False)
        self.act = FusedLeakyReLU(features) if activate else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.blur is not None:
            x = self.blur(x)
        x = self.conv(x)
        if self.act is not None:
            x = self.act(x)
        return x


class FromRGB(nn.Module):
    """1x1 ConvLayer from RGB (reference discriminator.py:17-19)."""

    def __init__(self, features: int, in_ch: int = 3):
        super().__init__()
        self.conv = ConvLayer(in_ch, features, 1, activate=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
