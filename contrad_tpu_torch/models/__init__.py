"""Architecture registry (the port of ``contrad_tpu/models/__init__.py``).

``get_architecture(name, image_size, device, dtype=)`` returns ``(G, D)``
modules on ``device`` computing in ``dtype``:
  * ``sndcgan``        — G_SNDCGAN + D_SNDCGAN(mlp_linear, d_hidden=512)
  * ``snresnet18``     — G_SNDCGAN + D_SNResNet18(mlp_linear, d_hidden=1024)
  * ``stylegan2``      — small32 StyleGAN2 G + ResidualDiscriminatorP(d_hidden=512)
  * ``stylegan2_512``  — full StyleGAN2 G/D, channel_multiplier 1.0,
    ``d_hidden=512`` (the 512x512 AFHQ recipe), unpacked: the JAX
    package's space-to-depth packing of the shallow levels is a TPU layout
    of the same function and parameter tree
  * ``stylegan2_tiny`` — test width (0.25x channels, n_mlp=2, d_hidden=32)
  * ``stylegan3_t_512`` — StyleGAN3-T's G (``models/stylegan3``, NVlabs'
    ``--cfg=stylegan3-t`` widths: cbase 32768, cmax 512, 14 layers, 2
    mapping layers) with ``stylegan2_512``'s D
  * ``stylegan3_t_tiny`` — its test width: 6 layers (one x4, a critically
    sampled pair, ToRGB), at most 32 channels, z and w of 32, with
    ``stylegan2_tiny``'s D

``batch_size``, where given, sets StyleGAN3's magnitude-EMA decay as NVlabs'
``train.py`` does, ``0.5 ** (batch_size / 20000)``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from contrad_tpu_torch import DtypeLike, reduced_dtype, resolve_device
from contrad_tpu_torch.models.base import (
    Discriminator, NullDiscriminator, l2_normalize_rows, projection)


ARCHITECTURES = ("sndcgan", "snresnet18", "stylegan2", "stylegan2_512",
                 "stylegan2_tiny", "stylegan3_t_512", "stylegan3_t_tiny")


# stylegan3_t_tiny's schedule (synthesis_schedule's keywords): at 32x32,
# widths 32, 32, 23, 13, 8, 8, 3 and rates 16, 16, 32, ...: L2 upsamples x4
TINY_SCHEDULE = dict(channel_base=256, channel_max=32, num_layers=6)


def get_architecture(architecture: str, image_size: Tuple[int, int, int],
                     device: str | torch.device = "cuda",
                     seed: Optional[int] = None, n_classes: int = 1,
                     dtype: DtypeLike = torch.float32,
                     batch_size: Optional[int] = None
                     ) -> Tuple[nn.Module, Discriminator]:
    """Build (G, D) on ``device`` with float32 parameters, computing in
    ``dtype`` (``torch.float32`` or ``torch.bfloat16``, or ``f32``/``bf16``):
    the conv stacks of every family take it, while the heads, the style MLP
    and the loss math stay float32 (``contrad_tpu/models/__init__.py:30-94``).
    ``seed`` makes the random initialisation reproducible. ``n_classes > 1``
    adds the projection discrimination head (``SNEmbed``; reference
    base.py:107-130)."""
    from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan
    from contrad_tpu_torch.models.snresnet import DSnresnet18
    from contrad_tpu_torch.models.stylegan2 import DStylegan2, GStylegan2
    from contrad_tpu_torch.models.stylegan3 import GStylegan3

    device = resolve_device(device)
    dtype = reduced_dtype(dtype)
    resolution = image_size[0]
    if architecture not in ARCHITECTURES:
        raise NotImplementedError(f"unknown architecture: {architecture}")
    beta = (0.999 if batch_size is None
            else 0.5 ** (batch_size / (20 * 1e3)))
    # Parameters are drawn on the CPU from a forked global generator, so a
    # seed gives the same weights on every device and the caller's random
    # state is left as it was.
    with torch.random.fork_rng(devices=[]):
        if seed is not None:
            torch.manual_seed(seed)
        if architecture == "sndcgan":
            generator = GSndcgan(image_size, dtype=dtype)
            discriminator = DSndcgan(image_size, mlp_linear=True,
                                     d_hidden=512, n_classes=n_classes,
                                     dtype=dtype)
        elif architecture == "snresnet18":
            generator = GSndcgan(image_size, dtype=dtype)
            discriminator = DSnresnet18(mlp_linear=True, d_hidden=1024,
                                        n_classes=n_classes, dtype=dtype)
        elif architecture == "stylegan2":
            generator = GStylegan2(size=resolution, n_mlp=8, small32=True,
                                   dtype=dtype)
            discriminator = DStylegan2(size=resolution, small32=True,
                                       mlp_linear=True, d_hidden=512,
                                       n_classes=n_classes, dtype=dtype)
        elif architecture == "stylegan2_512":
            generator = GStylegan2(size=resolution, n_mlp=8,
                                   channel_multiplier=1.0, dtype=dtype)
            discriminator = DStylegan2(size=resolution, channel_multiplier=1.0,
                                       mlp_linear=True, d_hidden=512,
                                       n_classes=n_classes, dtype=dtype)
        elif architecture == "stylegan3_t_512":
            generator = GStylegan3(size=resolution, magnitude_ema_beta=beta,
                                   dtype=dtype)
            discriminator = DStylegan2(size=resolution, channel_multiplier=1.0,
                                       mlp_linear=True, d_hidden=512,
                                       n_classes=n_classes, dtype=dtype)
        elif architecture == "stylegan3_t_tiny":
            generator = GStylegan3(size=resolution, z_dim=32, w_dim=32,
                                   magnitude_ema_beta=beta, dtype=dtype,
                                   **TINY_SCHEDULE)
            discriminator = DStylegan2(size=resolution, channel_multiplier=0.25,
                                       mlp_linear=True, d_hidden=32,
                                       n_classes=n_classes, dtype=dtype)
        else:
            generator = GStylegan2(size=resolution, n_mlp=2,
                                   channel_multiplier=0.25, dtype=dtype)
            discriminator = DStylegan2(size=resolution, channel_multiplier=0.25,
                                       mlp_linear=True, d_hidden=32,
                                       n_classes=n_classes, dtype=dtype)
    return generator.to(device), discriminator.to(device)


def generate(generator: nn.Module, z: torch.Tensor,
             noise_rng: Optional[torch.Generator] = None,
             noise: Optional[List[torch.Tensor]] = None,
             rows: slice = slice(None)) -> torch.Tensor:
    """Eval-mode images of ``generator`` from latents ``z``: SNDCGAN with its
    running batch-norm statistics; StyleGAN2 clamped to [0, 1], without
    style mixing, with the noise maps ``noise`` or, where None, maps drawn
    from ``noise_rng`` for all of ``z``. Only the ``rows`` of ``z`` (and of
    the noise) are generated: a rank of a world draws a whole chunk and
    samples its share of it."""
    from contrad_tpu_torch.models.stylegan2 import GStylegan2

    if isinstance(generator, GStylegan2):
        if noise is None:
            noise = generator.draw_noise(z.shape[0], noise_rng, z.device)
        return generator(z[rows], [n[rows] for n in noise], None,
                         train=False)
    return generator(z[rows], train=False)


__all__ = ["ARCHITECTURES", "get_architecture", "generate", "Discriminator",
           "NullDiscriminator", "l2_normalize_rows", "projection"]
