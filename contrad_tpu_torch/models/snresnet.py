"""Spectral-norm ResNet discriminators (the port of
``contrad_tpu/models/snresnet.py``; reference ``models/gan/snresnet.py``).

ResNet-18/34 feature stacks without normalisation layers, LeakyReLU(0.1),
spectral norm on every conv (the port's :class:`SNConv`, with its ``u``
buffer) and on the heads, then a 4x4 average pool to the 512-d penultimate
features (reference ``snresnet.py:73-86``). Images are NHWC in [0, 1] at the
interface; inside, the convs run on NCHW views that are ``channels_last`` in
memory. Weights start lecun-normal, biases at 0, as flax's defaults. Under
a bfloat16 compute dtype (``dtype``) the input ``x * 2 - 1`` and every conv
run in it, and the features reach the heads in float32
(``contrad_tpu/models/snresnet.py:30-76``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch import at_least_f32, cast
from contrad_tpu_torch.models.base import Discriminator
from contrad_tpu_torch.ops.spectral_norm import SNConv


class BasicBlock(nn.Module):
    """conv3x3 -> lrelu -> conv3x3 (+ 1x1 shortcut where the shape changes)
    -> lrelu (reference snresnet.py:22-40)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_sn: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SNConv(in_planes, planes, 3, stride=stride, padding=1,
                            use_sn=use_sn, dtype=dtype)
        self.conv2 = SNConv(planes, planes, 3, padding=1, use_sn=use_sn,
                            dtype=dtype)
        self.shortcut = (SNConv(in_planes, planes, 1, stride=stride,
                                use_sn=use_sn, dtype=dtype)
                         if stride != 1 or in_planes != planes else None)

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        out = F.leaky_relu(self.conv1(x, train, persist), 0.1)
        out = self.conv2(out, train, persist)
        if self.shortcut is not None:
            x = self.shortcut(x, train, persist)
        return F.leaky_relu(out + x, 0.1)


class SnresnetBackbone(nn.Module):
    """(N, H, W, 3) in [0, 1] -> ResNet stack -> avg_pool(4) -> (N, 512 ·
    H/32 · W/32) features, flattened in (h, w, c) order as JAX flattens.
    Blocks are named ``layer<stage>_<block>`` as in the JAX tree."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 use_sn: bool = True, in_ch: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SNConv(in_ch, 64, 3, padding=1, use_sn=use_sn,
                            dtype=dtype)
        self.blocks = []
        in_planes = 64
        for stage, (planes, n_blocks, stride) in enumerate(
                zip((64, 128, 256, 512), num_blocks, (1, 2, 2, 2))):
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, BasicBlock(
                    in_planes, planes, stride if b == 0 else 1, use_sn, dtype))
                self.blocks.append(name)
                in_planes = planes

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        x = cast(x * 2.0 - 1.0, self.dtype).permute(0, 3, 1, 2)
        x = F.leaky_relu(self.conv1(x, train, persist), 0.1)
        for name in self.blocks:
            x = getattr(self, name)(x, train, persist)
        x = F.avg_pool2d(x, 4)
        return at_least_f32(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def _make(num_blocks, d_hidden: int = 128, use_sn: bool = True,
          n_classes: int = 1, dtype: Optional[torch.dtype] = None,
          mlp_linear: bool = False) -> Discriminator:
    # 512 channels x 1 x 1 after avg_pool(4) on the /8 features of 32x32
    return Discriminator(
        backbone=SnresnetBackbone(num_blocks, use_sn, dtype=dtype),
        d_penul=512, d_hidden=d_hidden, use_sn=use_sn, n_classes=n_classes,
        mlp_linear=mlp_linear)


def DSnresnet18(d_hidden: int = 128, use_sn: bool = True, n_classes: int = 1,
                dtype: Optional[torch.dtype] = None,
                mlp_linear: bool = False) -> Discriminator:
    return _make((2, 2, 2, 2), d_hidden, use_sn, n_classes, dtype, mlp_linear)


def DSnresnet34(d_hidden: int = 128, use_sn: bool = True, n_classes: int = 1,
                dtype: Optional[torch.dtype] = None,
                mlp_linear: bool = False) -> Discriminator:
    return _make((3, 4, 6, 3), d_hidden, use_sn, n_classes, dtype, mlp_linear)
