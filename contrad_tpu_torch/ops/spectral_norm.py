"""Dense layer of the discriminator heads (the port of
``contrad_tpu/ops/spectral_norm.py::SNDense``).

Only the ``use_sn=False`` path is ported: the StyleGAN2 discriminator has no
spectral norm (``contrad_tpu/models/stylegan2/discriminator.py:157``). The
power-iteration state comes with the SNDCGAN slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_LECUN_TRUNC_STD = 0.87962566103423978  # std of N(0,1) truncated to [-2, 2]


class SNDense(nn.Module):
    """``y = x @ W.T + b`` with flax's lecun_normal init. ``weight`` is
    (out, in), torch's layout; the JAX ``kernel`` is its transpose."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 use_sn: bool = False):
        super().__init__()
        if use_sn:
            raise NotImplementedError(
                "spectral norm is not ported yet (StyleGAN2 heads use none)")
        std = math.sqrt(1.0 / in_features) / _LECUN_TRUNC_STD
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(features, in_features), std=std, a=-2 * std, b=2 * std))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
