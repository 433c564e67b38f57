"""SNDCGAN generator and discriminator (the port of
``contrad_tpu/models/sndcgan.py``; reference ``models/gan/sndcgan.py``).

Images are NHWC in [0, 1] at the interfaces, as in the JAX package. Inside,
the convolutions run on NCHW views that are ``channels_last`` in memory, so
neither end needs a copy. Where the JAX package's layout shows through, the
port follows it:

  * G reshapes its dense output channel-major, (N, 8·ngf, H/8, W/8), as the
    reference does;
  * D flattens its features in (h, w, c) order, so the rows of the heads'
    first weights are in that order.

Every conv, conv-transpose, dense layer and head weight starts at
N(0, 0.02) and every bias at 0. G's batch norms start at scale 1, bias 0.

Under a bfloat16 compute dtype (``dtype``) G's dense layer, conv-transposes
and batch norms run in it (the norms take their statistics and normalise in
float32, as flax's ``BatchNorm(dtype=)`` does), ``tanh`` runs in float32,
and G emits bfloat16 in training and float32 in eval; D casts its input
``x * 2 - 1`` to bfloat16 and hands its features to the heads in float32
(``contrad_tpu/models/sndcgan.py:36-110``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch import at_least_f32, cast
from contrad_tpu_torch.models.base import Discriminator
from contrad_tpu_torch.ops.spectral_norm import SNConv, dcgan_normal_
from contrad_tpu_torch.parallel import data_shard, global_var_mean


def _dcgan(layer: nn.Module) -> nn.Module:
    dcgan_normal_(layer.weight.data)
    nn.init.zeros_(layer.bias)
    return layer


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of an
    (N, C) or NCHW tensor. In train mode it normalises with the batch's mean
    and biased variance and moves the running statistics to
    ``0.9 * running + 0.1 * batch``. ``torch.nn.BatchNorm`` would keep the
    unbiased variance there, larger by n / (n - 1). In eval mode it
    normalises with the running statistics. A bfloat16 input is normalised
    in float32 against the float32 statistics and parameters, and the
    result rounded to bfloat16 (``F.batch_norm``'s mixed-dtype form).

    In a world of more than one process the train-mode statistics are the
    global batch's (``parallel.global_var_mean``, which carries their
    gradient across the ranks), as XLA reduces them over the JAX package's
    mesh, so the running statistics move identically on every rank. A world
    of one has nothing to reduce and takes the world-less path."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if data_shard()[1] > 1:
            return self._global(x)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(at_least_f32(x), dim=dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the world's global batch."""
        dims = [0] + list(range(2, x.dim()))
        xf = at_least_f32(x)
        var, mean = global_var_mean(xf, dims)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        shape = [1, -1] + [1] * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * scale.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)


class GSndcgan(nn.Module):
    """z in U(-1, 1)^nz -> image in [0, 1]^(H, W, C).

    Dense -> BN -> ReLU -> 3x(ConvT 4x4 s2 + BN + ReLU) -> 3x3 conv -> tanh,
    rescaled to [0, 1] (reference ``sndcgan.py:13-52``). The first batch
    norm takes the whole dense output as its channels, as the reference's
    BatchNorm2d on (N, C, 1, 1) does.

    The conv-transposes hold torch's (in, out, kH, kW) weights. JAX's
    ``conv_transpose`` does not flip its kernel and torch's does, so the
    bridge hands over the JAX kernel flipped in both spatial axes
    (``contrad_tpu_torch/bridge.py``)."""

    def __init__(self, image_size: Tuple[int, int, int], ngf: int = 64,
                 nz: int = 128, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        s_h, s_w, nc = image_size
        self.base = (ngf * 8, s_h // 8, s_w // 8)
        self.nz = nz
        width = ngf * 8 * (s_h // 8) * (s_w // 8)
        self.linear = _dcgan(nn.Linear(nz, width))
        self.norm_init = BatchNorm(width)
        chans = (ngf * 8, ngf * 4, ngf * 2, ngf)
        for i in range(3):
            self.add_module(f"up{i}", _dcgan(nn.ConvTranspose2d(
                chans[i], chans[i + 1], 4, stride=2, padding=1)))
            self.add_module(f"norm{i}", BatchNorm(chans[i + 1]))
        self.to_rgb = _dcgan(nn.Conv2d(ngf, nc, 3, padding=1))

    def sample_latent(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n latents from U(-1, 1)^nz on ``generator``'s device, in the
        weights' dtype."""
        u = torch.rand(n, self.nz, generator=generator,
                       device=generator.device, dtype=self.linear.weight.dtype)
        return u * 2.0 - 1.0

    def _params(self, layer: nn.Module):
        return cast(layer.weight, self.dtype), cast(layer.bias, self.dtype)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = F.linear(cast(z, self.dtype), *self._params(self.linear))
        x = F.relu(self.norm_init(x, train))
        x = x.reshape(-1, *self.base).contiguous(
            memory_format=torch.channels_last)
        for i in range(3):
            up, norm = getattr(self, f"up{i}"), getattr(self, f"norm{i}")
            x = F.conv_transpose2d(x, *self._params(up), stride=2, padding=1)
            x = F.relu(norm(x, train))
        x = F.conv2d(x, *self._params(self.to_rgb), padding=1)
        x = 0.5 * torch.tanh(at_least_f32(x)) + 0.5
        # training emits the compute dtype, eval float32 (JAX's rule)
        return (cast(x, self.dtype) if train else x).permute(0, 2, 3, 1)


class SndcganBackbone(nn.Module):
    """7 spectral-norm convs with LeakyReLU(0.1) (reference
    ``sndcgan.py:92-125``): (N, H, W, 3) in [0, 1] -> (N, 8·ndf·H/8·W/8)."""

    def __init__(self, image_size: Tuple[int, int, int], ndf: int = 64,
                 use_sn: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        c = image_size[2]
        layers = ((c, ndf, 3, 1), (ndf, ndf * 2, 4, 2),
                  (ndf * 2, ndf * 2, 3, 1), (ndf * 2, ndf * 4, 4, 2),
                  (ndf * 4, ndf * 4, 3, 1), (ndf * 4, ndf * 8, 4, 2),
                  (ndf * 8, ndf * 8, 3, 1))
        self.convs = [f"c{i}" for i in range(len(layers))]
        for name, (cin, cout, k, s) in zip(self.convs, layers):
            self.add_module(name, SNConv(cin, cout, k, stride=s, padding=1,
                                         use_sn=use_sn, init=dcgan_normal_,
                                         dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        x = cast(x * 2.0 - 1.0, self.dtype).permute(0, 3, 1, 2)
        for name in self.convs:
            x = F.leaky_relu(getattr(self, name)(x, train, persist), 0.1)
        # (h, w, c) order, as the JAX package flattens NHWC; heads in f32
        return at_least_f32(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def sndcgan_n_features(image_size: Tuple[int, int, int], ndf: int = 64) -> int:
    s_h, s_w, _ = image_size
    return ndf * 8 * (s_h // 8) * (s_w // 8)


def DSndcgan(image_size: Tuple[int, int, int], ndf: int = 64,
             d_hidden: int = 128, n_classes: int = 1,
             dtype: Optional[torch.dtype] = None,
             mlp_linear: bool = False) -> Discriminator:
    """SNDCGAN backbone + the three heads, all spectral-normed, heads at
    N(0, 0.02) (the reference re-inits them so); ``mlp_linear`` as in
    :class:`~contrad_tpu_torch.models.base.Discriminator`."""
    return Discriminator(
        backbone=SndcganBackbone(image_size, ndf, dtype=dtype),
        d_penul=sndcgan_n_features(image_size, ndf), d_hidden=d_hidden,
        use_sn=True, head_init=dcgan_normal_, n_classes=n_classes,
        mlp_linear=mlp_linear)
