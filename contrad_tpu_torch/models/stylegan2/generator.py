"""StyleGAN2 generator (the port of
``contrad_tpu/models/stylegan2/generator.py``).

The modulated conv keeps the JAX package's factorised form,
``y[b] = demod[b] * conv(x[b] * style[b], scale * W)``, and its upsampling
layer takes the reference's unfused form: transposed conv, demodulation,
then the FIR blur through the hand-written blur kernel
(``generator.py:132-141``).

Under a bfloat16 compute dtype (``dtype``) the synthesis runs in it: the
constant input, the convs and the noise; the style MLP, the modulation and
the demodulation stay float32 from a float32 style, and the image is
bfloat16 in training and float32 in eval
(``contrad_tpu/models/stylegan2/generator.py:79-92,260,368-400``).

Random draws are explicit: :meth:`GStylegan2.draw_noise` and
:meth:`GStylegan2.draw_mixing` make them from a ``torch.Generator``, and the
forward takes them as arguments, so the tests can feed the draws JAX made.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch import at_least_f32, cast
from contrad_tpu_torch.models.stylegan2.layers import (
    Blur, EqualDense, conv2d_nhwc, pixel_norm)
from contrad_tpu_torch.ops.fused_act import FusedLeakyReLU
from contrad_tpu_torch.ops.upfirdn2d import make_kernel, upsample2d

# (z_mix, mix_layer): the second latent and, per sample, the first layer
# that takes it (n_latent = no mixing for that sample).
Mixing = Tuple[torch.Tensor, torch.Tensor]


def stylegan2_channels(channel_multiplier: float = 2.0, small32: bool = False):
    """Resolution -> channel map (reference generator.py:161-179)."""
    if small32:
        return {4: 512, 8: 512, 16: 256, 32: 128}
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: int(256 * channel_multiplier),
        128: int(128 * channel_multiplier),
        256: int(64 * channel_multiplier),
        512: int(32 * channel_multiplier),
        1024: int(16 * channel_multiplier),
    }


class ModulatedConv(nn.Module):
    """Style-modulated, optionally demodulated conv (reference
    generator.py:17-82). ``weight`` is OIHW and raw (scaled at run time)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True,
                 upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), eps: float = 1e-8):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn(features, in_ch, k, k))
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.modulation = EqualDense(style_dim, in_ch, bias_init=1.0)
        self.demodulate = demodulate
        self.upsample = upsample
        self.eps = eps
        self.kernel_size = k
        if upsample:
            p = (len(blur_kernel) - 2) - (k - 1)
            self.blur = Blur(blur_kernel, pad=((p + 1) // 2 + 1, p // 2 + 1),
                             upsample_factor=2)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        w = self.weight * self.scale
        s = self.modulation(style.to(self.weight.dtype))  # (N, in)
        xm = x * s[:, None, None, :].to(x.dtype)
        wx = w.to(x.dtype)
        if self.upsample:
            # jax.lax.conv_transpose does not flip its kernel and
            # torch.conv_transpose2d does: flip here so the two agree.
            wt = wx.transpose(0, 1).flip(2, 3)
            y = F.conv_transpose2d(xm.permute(0, 3, 1, 2), wt, stride=2)
            y = y.permute(0, 2, 3, 1)
        else:
            y = conv2d_nhwc(xm, wx, padding=self.kernel_size // 2)
        if self.demodulate:
            w_sq = torch.sum(w**2, dim=(2, 3))  # (out, in)
            demod = torch.rsqrt(s**2 @ w_sq.t() + self.eps)  # (N, out)
            y = y * demod[:, None, None, :].to(y.dtype)
        if self.upsample:
            y = self.blur(y)
        return y


class NoiseInjection(nn.Module):
    """x + weight * noise, noise (N, H, W, 1) (reference generator.py:85-94)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class ConstantInput(nn.Module):
    """Learned 4x4 constant, NHWC (1, size, size, C) (reference
    generator.py:97-105)."""

    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.const = nn.Parameter(torch.randn(1, size, size, channels))

    def forward(self, batch: int,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return cast(self.const, dtype).expand(batch, -1, -1, -1)


class StyleLayer(nn.Module):
    """ModulatedConv -> noise -> fused leaky-relu (reference
    generator.py:108-124)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv(in_ch, features, kernel_size, style_dim,
                                  upsample=upsample, blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(features)

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    """1x1 modulated (not demodulated) conv to RGB + skip upsample
    (reference generator.py:127-146)."""

    def __init__(self, in_ch: int, style_dim: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, 3))
        self.kernel = make_kernel(blur_kernel)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + upsample2d(skip, self.kernel).to(out.dtype)
        return out


class GStylegan2(nn.Module):
    """Style MLP + progressive synthesis with the skip ToRGB chain
    (reference generator.py:149-290). Images NHWC in [0, 1], clamped in
    eval."""

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: float = 2.0,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01, small32: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.size = size
        self.style_dim = style_dim
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        channels = stylegan2_channels(channel_multiplier, small32)

        self.style = nn.ModuleList([
            EqualDense(style_dim, style_dim, lr_mul=lr_mlp, activation=True)
            for _ in range(n_mlp)])
        self.input = ConstantInput(channels[4])
        self.conv1 = StyleLayer(channels[4], channels[4], 3, style_dim,
                                blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(channels[4], style_dim, blur_kernel)
        self.layers = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, self.log_size + 1):
            out_ch = channels[2**i]
            self.layers.append(StyleLayer(in_ch, out_ch, 3, style_dim,
                                          upsample=True,
                                          blur_kernel=blur_kernel))
            self.layers.append(StyleLayer(out_ch, out_ch, 3, style_dim,
                                          blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, blur_kernel))
            in_ch = out_ch

    # ------------------------------------------------------------- draws

    def noise_shapes(self, n: int) -> List[Tuple[int, int, int, int]]:
        shapes = [(n, 4, 4, 1)]
        for i in range(3, self.log_size + 1):
            shapes += [(n, 2**i, 2**i, 1)] * 2
        return shapes

    def sample_latent(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n latents from N(0, 1)^style_dim on ``generator``'s device."""
        return torch.randn(n, self.style_dim, generator=generator,
                           device=generator.device)

    def draw_noise(self, n: int, generator: torch.Generator,
                   device: torch.device) -> List[torch.Tensor]:
        return [torch.randn(s, generator=generator, device=device)
                for s in self.noise_shapes(n)]

    def draw_mixing(self, n: int, style_mix: float,
                    generator: torch.Generator, device: torch.device) -> Mixing:
        """Per-sample style mixing (reference generator.py:252-266): with
        probability ``style_mix`` a crossover layer, else none."""
        nomix = torch.rand(n, generator=generator, device=device) >= style_mix
        layer = torch.randint(0, self.n_latent, (n,), generator=generator,
                              device=device)
        z_mix = torch.randn(n, self.style_dim, generator=generator,
                            device=device)
        return z_mix, torch.where(nomix, self.n_latent, layer)

    def draws(self, n: int, generator: torch.Generator,
              style_mix: float) -> dict:
        """The random inputs of a train-mode forward at batch ``n``, drawn
        in this order: latents, noise maps, and the style mixing where
        ``style_mix`` > 0 (else None)."""
        device = generator.device
        return {"z": self.sample_latent(n, generator),
                "noise": self.draw_noise(n, generator, device),
                "mixing": (self.draw_mixing(n, style_mix, generator, device)
                           if style_mix > 0 else None)}

    # ------------------------------------------------------------- forward

    def style_forward(self, z: torch.Tensor) -> torch.Tensor:
        """z -> w (the style MLP; reference get_latent)."""
        x = pixel_norm(z)
        for layer in self.style:
            x = layer(x)
        return x

    def mean_latent(self, n_latent: int,
                    generator: torch.Generator) -> torch.Tensor:
        """The mean w of ``n_latent`` latents drawn from ``generator``,
        (1, style_dim)
        (``contrad_tpu/models/stylegan2/generator.py:334-336``)."""
        z = self.sample_latent(n_latent, generator)
        return torch.mean(self.style_forward(z), dim=0, keepdim=True)

    def forward(self, z: torch.Tensor, noise: List[torch.Tensor],
                mixing: Optional[Mixing] = None, train: bool = True,
                input_is_latent: bool = False, return_latents: bool = False):
        """Images from latents ``z`` (N, style_dim), or with
        ``input_is_latent`` from styles w: (N, style_dim), one a sample,
        or (N, n_latent, style_dim), one a layer. ``mixing`` replaces the
        layers from each sample's crossover on with the style of
        ``z_mix``, which goes through the style MLP whatever the input.
        ``return_latents`` returns ``(image, latents)``, the per-layer
        styles after mixing."""
        latent = z if input_is_latent else self.style_forward(z)
        latents = (latent if latent.dim() == 3
                   else latent[:, None, :].expand(-1, self.n_latent, -1))
        if mixing is not None:
            z_mix, mix_layer = mixing
            latent_mix = self.style_forward(z_mix)[:, None, :]
            idx = torch.arange(self.n_latent, device=z.device)[None, :]
            mask = (idx < mix_layer[:, None]).to(latents.dtype)[..., None]
            latents = latents * mask + latent_mix * (1.0 - mask)

        out = self.input(latents.shape[0], self.dtype)
        out = self.conv1(out, latents[:, 0], noise[0])
        skip = self.to_rgb1(out, latents[:, 1])
        idx = 1
        for i, to_rgb in enumerate(self.to_rgbs):
            out = self.layers[2 * i](out, latents[:, idx], noise[1 + 2 * i])
            out = self.layers[2 * i + 1](out, latents[:, idx + 1],
                                         noise[2 + 2 * i])
            skip = to_rgb(out, latents[:, idx + 2], skip)
            idx += 2
        # training emits the compute dtype, eval float32 (JAX's rule)
        if train:
            image = 0.5 * cast(skip, self.dtype) + 0.5
        else:
            image = torch.clamp(0.5 * at_least_f32(skip) + 0.5, 0.0, 1.0)
        return (image, latents) if return_latents else image
