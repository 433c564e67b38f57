"""Training modes (the port of ``contrad_tpu/training/modes.py``; the
``contrad`` mode).

``loss_D(ctx, D, images, gen_images, aug_params)`` -> (total, metrics) and
``loss_G(ctx, D, gen_images, aug_params)`` -> g_loss. The augmentation's
parameters are arguments, drawn by the caller (``ctx.augment.sample``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from contrad_tpu_torch import at_least_f32
from contrad_tpu_torch.models.base import l2_normalize_rows
from contrad_tpu_torch.training.losses import (
    gan_d_loss, gan_g_loss, nt_xent, supcon_fake)

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModeCtx:
    augment: Any  # has sample(shape, rng) and apply(x, params)
    loss_type: str
    temp: float = 0.1
    lbd_a: float = 1.0


def contrad_loss_D(ctx: ModeCtx, D, images, gen_images, aug_params
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Reference ``contrad.py:35-70``: one D pass over augmented
    [real, real, fake]; the GAN head sees detached features, so the
    backbone's gradient is purely contrastive."""
    n = images.shape[0]
    cat_images = torch.cat([images, images, gen_images.detach()], dim=0)
    d_all, aux = D(ctx.augment.apply(cat_images, aug_params), sg_linear=True)

    views = l2_normalize_rows(at_least_f32(aux["projection"]))
    simclr_loss = nt_xent(views[:n], views[n:2 * n], temperature=ctx.temp)
    reals = l2_normalize_rows(at_least_f32(aux["projection2"]))
    sup_loss = supcon_fake(reals[:n], reals[n:2 * n], reals[2 * n:],
                           temperature=ctx.temp)

    d_real, d_gen = d_all[:n], d_all[2 * n:3 * n]
    head_loss = gan_d_loss(d_real, d_gen, ctx.loss_type)
    contrastive = simclr_loss + ctx.lbd_a * sup_loss
    metrics = {"D_loss": contrastive, "D_penalty": head_loss,
               "D_real": d_real.mean(), "D_gen": d_gen.mean()}
    return contrastive + head_loss, metrics


def augmented_loss_G(ctx: ModeCtx, D, gen_images, aug_params) -> torch.Tensor:
    """G loss on augmented fakes (``_augmented_loss_G_lsgan_ok``)."""
    d_gen, _ = D(ctx.augment.apply(gen_images, aug_params))
    return gan_g_loss(d_gen, ctx.loss_type)


_MODES: Dict[str, Tuple[Callable, Callable]] = {
    "contrad": (contrad_loss_D, augmented_loss_G),
}


def get_mode(mode: str) -> Tuple[Callable, Callable]:
    """Returns (loss_D, loss_G) for a training mode."""
    if mode not in _MODES:
        raise NotImplementedError(f"training mode {mode!r} is not ported yet")
    return _MODES[mode]
