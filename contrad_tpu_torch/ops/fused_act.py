"""Bias + LeakyReLU with a sqrt(2) gain (the port of
``contrad_tpu/ops/fused_act.py``; an XLA elementwise expression there, so
plain PyTorch here)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """out = leaky_relu(x + bias[channel]) * scale; channels last."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return F.leaky_relu(x, negative_slope) * scale


class FusedLeakyReLU(nn.Module):
    """Per-channel-bias leaky ReLU with sqrt(2) gain (StyleGAN2 convention)."""

    def __init__(self, channels: int, negative_slope: float = 0.2,
                 scale: float = math.sqrt(2.0)):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
