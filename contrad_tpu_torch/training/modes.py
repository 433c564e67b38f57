"""Training modes (the port of ``contrad_tpu/training/modes.py``; reference
``training/gan/{std,aug,aug_both,simclr_only,contrad}.py``).

``loss_D(ctx, D, images, gen_images, draws, y_real, y_gen)`` -> (total,
metrics) and ``loss_G(ctx, D, gen_images, aug_params, y_gen)`` -> g_loss.
``y_real`` and ``y_gen``, the labels of the reals and of the fakes, reach a
conditional D's passes in the order of the batch they score (``_cat_y``);
they are None for an unconditional D. ``draws`` is a
:class:`Draws`: the parameters of the mode's augmentation of the D batch
and the penalty's draws, made by the caller (:func:`draw_d`), so the tests
can pass the draws JAX made. The total is ``d_loss + penalty`` as the
reference trainer adds them; the metrics carry D_loss, D_penalty, D_real
and D_gen.

  * ``std``         — GAN loss on [real, fake]; penalty configurable.
  * ``aug``         — augments the reals only in the D loss; G unaugmented.
  * ``aug_both``    — augments [real, fake] in D and the fakes in G; it has
                      no lsgan branch.
  * ``simclr_only`` — D trained by NT-Xent on two views of the reals alone; G
                      against the (GAN-untrained) head on augmented fakes.
  * ``contrad``     — one D pass over augmented [real, real, fake] with the
                      GAN head on detached features; backbone loss NT-Xent +
                      lbd_a * supcon, the GAN head's loss in the penalty slot.

Each mode's main D pass persists the spectral-norm state (``D(x)``); the
penalties' passes do not.

In a world of processes (``parallel/``) each rank runs D on its own rows
and every loss is taken over the global batch: the D outputs and features
are split into their parts (reals, each view, fakes) first and each part is
gathered rank-major (``gather_rows``), so that a part's global rows stand in
the order a world of one has them. A D pass's concatenation is never
gathered whole: its order would be ``[r0: v1, v2, gen; r1: v1, v2, gen]``,
not ``[v1; v2; gen]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from contrad_tpu_torch import at_least_f32
from contrad_tpu_torch.models.base import l2_normalize_rows
from contrad_tpu_torch.parallel import gather_rows
from contrad_tpu_torch.training import penalty as penalties
from contrad_tpu_torch.training.losses import (
    gan_d_loss, gan_g_loss, nt_xent, supcon_fake)

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModeCtx:
    augment: Any  # has sample(shape, rng) and apply(x, params)
    loss_type: str
    temp: float = 0.1
    lbd_a: float = 1.0
    penalty: str = "none"
    lbd: float = 10.0
    lbd2: float = 10.0


class Draws(NamedTuple):
    """The random draws of one D loss."""

    aug: Any = None  # the mode's augmentation of the D batch
    penalty: Any = None  # penalty.sample(...)


def _metrics(d_loss, penalty, d_real, d_gen) -> Metrics:
    return {"D_loss": d_loss, "D_penalty": penalty,
            "D_real": d_real.mean(), "D_gen": d_gen.mean()}


def _cat_y(y_real, y_gen, *parts) -> Optional[torch.Tensor]:
    """The labels of a multi-part D batch, each part ``"real"`` or
    ``"gen"``; None when unconditional."""
    if y_real is None and y_gen is None:
        return None
    vecs = {"real": y_real, "gen": y_gen}
    return torch.cat([vecs[p] for p in parts], dim=0)


def _gan_loss_D(ctx, D, images, gen_images, d_input, all_images, draws,
                y_real, y_gen):
    """The GAN loss on ``D(d_input)`` = [real, fake] plus the penalty, which
    gets ``all_images`` as the mode's [real, fake] batch."""
    n = images.shape[0]
    d_all, _ = D(d_input, y=_cat_y(y_real, y_gen, "real", "gen"))
    d_real, d_gen = d_all[:n], d_all[n:]
    all_real, all_gen = gather_rows(d_real), gather_rows(d_gen)
    d_loss = gan_d_loss(all_real, all_gen, ctx.loss_type)
    penalty = penalties.compute_penalty(
        ctx, D, images=images, gen_images=gen_images, all_images=all_images,
        d_real=d_real, d_gen=d_gen, params=draws.penalty, y_real=y_real,
        y_gen=y_gen)
    return d_loss + penalty, _metrics(d_loss, penalty, all_real, all_gen)


def std_loss_D(ctx: ModeCtx, D, images, gen_images, draws: Draws,
               y_real=None, y_gen=None):
    gen_images = gen_images.detach()
    all_images = torch.cat([images, gen_images], dim=0)
    return _gan_loss_D(ctx, D, images, gen_images, all_images, all_images,
                       draws, y_real, y_gen)


def aug_loss_D(ctx: ModeCtx, D, images, gen_images, draws: Draws,
               y_real=None, y_gen=None):
    gen_images = gen_images.detach()
    all_images = torch.cat([ctx.augment.apply(images, draws.aug), gen_images],
                           dim=0)
    return _gan_loss_D(ctx, D, images, gen_images, all_images, all_images,
                       draws, y_real, y_gen)


def aug_both_loss_D(ctx: ModeCtx, D, images, gen_images, draws: Draws,
                    y_real=None, y_gen=None):
    if ctx.loss_type == "lsgan":
        raise NotImplementedError(
            "aug_both has no lsgan branch (reference aug_both.py)")
    gen_images = gen_images.detach()
    all_images = torch.cat([images, gen_images], dim=0)
    return _gan_loss_D(ctx, D, images, gen_images,
                       ctx.augment.apply(all_images, draws.aug), all_images,
                       draws, y_real, y_gen)


def simclr_only_loss_D(ctx: ModeCtx, D, images, gen_images, draws: Draws,
                       y_real=None, y_gen=None):
    """Labels are not used: the D pass trains the projection alone, as in
    the reference."""
    n = images.shape[0]
    real_images = torch.cat([images, images], dim=0)
    _, aux = D(ctx.augment.apply(real_images, draws.aug))
    views = l2_normalize_rows(at_least_f32(aux["projection"]))
    simclr_loss = nt_xent(gather_rows(views[:n]), gather_rows(views[n:]),
                          temperature=ctx.temp)
    zero = 0.0 * simclr_loss
    return simclr_loss, _metrics(simclr_loss, zero, zero, zero)


def contrad_loss_D(ctx: ModeCtx, D, images, gen_images, draws: Draws,
                   y_real=None, y_gen=None) -> Tuple[torch.Tensor, Metrics]:
    """Reference ``contrad.py:35-70``: one D pass over augmented
    [real, real, fake]; the GAN head sees detached features, so the
    backbone's gradient is purely contrastive."""
    n = images.shape[0]
    cat_images = torch.cat([images, images, gen_images.detach()], dim=0)
    d_all, aux = D(ctx.augment.apply(cat_images, draws.aug),
                   y=_cat_y(y_real, y_gen, "real", "real", "gen"),
                   sg_linear=True)

    views = l2_normalize_rows(at_least_f32(aux["projection"]))
    simclr_loss = nt_xent(gather_rows(views[:n]),
                          gather_rows(views[n:2 * n]), temperature=ctx.temp)
    reals = l2_normalize_rows(at_least_f32(aux["projection2"]))
    sup_loss = supcon_fake(gather_rows(reals[:n]),
                           gather_rows(reals[n:2 * n]),
                           gather_rows(reals[2 * n:]), temperature=ctx.temp)

    d_real = gather_rows(d_all[:n])
    d_gen = gather_rows(d_all[2 * n:3 * n])
    head_loss = gan_d_loss(d_real, d_gen, ctx.loss_type)
    contrastive = simclr_loss + ctx.lbd_a * sup_loss
    return contrastive + head_loss, _metrics(contrastive, head_loss, d_real,
                                             d_gen)


def std_loss_G(ctx: ModeCtx, D, gen_images, aug_params, y_gen=None
               ) -> torch.Tensor:
    """G loss on the fakes as they are (``aug_params`` unused)."""
    d_gen, _ = D(gen_images, y=y_gen)
    return gan_g_loss(gather_rows(d_gen), ctx.loss_type)


def augmented_loss_G(ctx: ModeCtx, D, gen_images, aug_params, y_gen=None
                     ) -> torch.Tensor:
    """G loss on augmented fakes (``_augmented_loss_G_lsgan_ok``)."""
    d_gen, _ = D(ctx.augment.apply(gen_images, aug_params), y=y_gen)
    return gan_g_loss(gather_rows(d_gen), ctx.loss_type)


def aug_both_loss_G(ctx: ModeCtx, D, gen_images, aug_params, y_gen=None
                    ) -> torch.Tensor:
    """G loss on augmented fakes, lsgan read as wgan (the reference's
    aug_both G loss has no lsgan branch; ``_augmented_loss_G``)."""
    d_gen, _ = D(ctx.augment.apply(gen_images, aug_params), y=y_gen)
    loss_type = "wgan" if ctx.loss_type == "lsgan" else ctx.loss_type
    return gan_g_loss(gather_rows(d_gen), loss_type)


class Mode(NamedTuple):
    loss_D: Callable
    loss_G: Callable
    d_aug_batches: int  # batches of N images the D loss augments (0: none)
    g_aug: bool  # the G loss augments the fakes


_MODES: Dict[str, Mode] = {
    "std": Mode(std_loss_D, std_loss_G, 0, False),
    "aug": Mode(aug_loss_D, std_loss_G, 1, False),
    "aug_both": Mode(aug_both_loss_D, aug_both_loss_G, 2, True),
    "simclr_only": Mode(simclr_only_loss_D, augmented_loss_G, 2, True),
    "contrad": Mode(contrad_loss_D, augmented_loss_G, 3, True),
}


def get_mode(mode: str) -> Mode:
    """The mode's losses and the shapes of their augmentation draws."""
    if mode not in _MODES:
        raise NotImplementedError(f"unknown training mode: {mode}")
    return _MODES[mode]


def draw_d(mode: Mode, ctx: ModeCtx, shape: Tuple[int, ...], rng) -> Draws:
    """The draws of one D loss on a real batch of ``shape`` (N, H, W, C)."""
    n, rest = shape[0], tuple(shape[1:])
    aug = (ctx.augment.sample((mode.d_aug_batches * n,) + rest, rng)
           if mode.d_aug_batches else None)
    return Draws(aug, penalties.sample(ctx.penalty, ctx.augment, shape, rng))


def run_filename(mode: str, penalty: str, aug: str, temp: float,
                 lbd_a: float) -> str:
    """A run's directory name (reference ``training/gan/__init__.py:9-24``)."""
    if mode == "std":
        filename = f"{mode}_{penalty}"
        if "cr" in penalty:
            filename += f"_{aug}"
    elif mode in ("aug", "aug_both"):
        filename = f"{mode}_{aug}_{penalty}"
    elif mode == "simclr_only":
        filename = f"{mode}_{aug}_T{temp}"
    elif mode == "contrad":
        filename = f"{mode}_{aug}_L{lbd_a}_T{temp}"
    else:
        raise NotImplementedError(f"unknown training mode: {mode}")
    return filename
