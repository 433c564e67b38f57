"""The StyleGAN2 train step (the port of
``contrad_tpu/training/step.py::StyleGAN2Trainer._sg2_step``).

Per step, as in the reference ``train_stylegan2.py:163-229``:
  1. EMA of G with the PRE-update parameters;
  2. the G phase first: fresh z, noise and style mixing, augmented fakes,
     the mode's G loss, one Adam update of G;
  3. the D phase on the G phase's (detached, pre-update) fakes: the mode's D
     loss plus, when ``do_r1``, the R1 penalty on augmented detached reals
     scaled by ``0.5 * lbd_r1 * d_reg_every``; one Adam update of D.
R1 is a gradient of a gradient through D, so the blur kernel's
``autograd.Function`` runs forward, backward and double backward here.

Every random draw comes from the trainer's :class:`AugRng`; the phase losses
(:meth:`g_loss`, :meth:`d_loss`) take their draws as arguments, so the tests
can feed the draws JAX made. A step never waits on the device: its metrics
stay there until the caller reads them.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import torch

from contrad_tpu_torch import at_least_f32
from contrad_tpu_torch.augment import AugRng
from contrad_tpu_torch.training.modes import ModeCtx, get_mode
from contrad_tpu_torch.training.state import ScheduledAdam, ema_update

Metrics = Dict[str, torch.Tensor]


def to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [0, 1]."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images.float()


class StyleGAN2Trainer:
    """Owns G, D, G's EMA copy, both optimisers and the random streams."""

    def __init__(self, generator, discriminator, mode: str, augment,
                 g_optimizer: ScheduledAdam, d_optimizer: ScheduledAdam,
                 loss_type: str, temp: float = 0.1, lbd_a: float = 1.0,
                 lbd_r1: float = 10.0, d_reg_every: int = 16,
                 style_mix: float = 0.9, n_critic: int = 1,
                 real_augment=None, seed: int = 0):
        if n_critic != 1:
            raise NotImplementedError("n_critic > 1 is not ported yet")
        self.generator = generator
        self.discriminator = discriminator
        self.g_ema = copy.deepcopy(generator).requires_grad_(False)
        self.g_tx, self.d_tx = g_optimizer, d_optimizer
        self.ctx = ModeCtx(augment, loss_type, temp, lbd_a)
        self.loss_D, self.loss_G = get_mode(mode)
        self.lbd_r1 = lbd_r1
        self.d_reg_every = d_reg_every
        self.style_mix = style_mix
        self.real_augment = real_augment
        self.device = next(generator.parameters()).device
        self.rng = AugRng.from_seed(seed, self.device)

    # ------------------------------------------------------------- draws

    def draw_g(self, n: int) -> Dict[str, Any]:
        """z, per-layer noise and style-mixing draws for one G forward."""
        g, dev = self.rng.device, self.device
        G = self.generator
        return {"z": torch.randn(n, G.style_dim, generator=g, device=dev),
                "noise": G.draw_noise(n, g, dev),
                "mixing": (G.draw_mixing(n, self.style_mix, g, dev)
                           if self.style_mix > 0 else None)}

    def draw_aug(self, shape):
        return self.ctx.augment.sample(tuple(shape), self.rng)

    # ------------------------------------------------------------- phases

    def g_loss(self, z, noise: List[torch.Tensor], mixing, aug_params
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """G-phase loss and the fakes it made."""
        gen_images = self.generator(z, noise, mixing, train=True)
        return self.loss_G(self.ctx, self.discriminator, gen_images,
                           aug_params), gen_images

    def r1(self, images: torch.Tensor, aug_params) -> torch.Tensor:
        """E[sum of squared grads of D(x) w.r.t. x] on augmented, detached
        reals (reference train_stylegan2.py:106-113), differentiable in D's
        parameters."""
        x = self.ctx.augment.apply(images, aug_params).detach()
        x.requires_grad_(True)
        d, _ = self.discriminator(x)
        (grads,) = torch.autograd.grad(d.sum(), x, create_graph=True)
        return at_least_f32(grads).reshape(x.shape[0], -1).pow(2).sum(dim=1).mean()

    def d_loss(self, images, gen_images, aug_params,
               r1_aug_params: Optional[Any] = None
               ) -> Tuple[torch.Tensor, Metrics]:
        """D-phase loss; with ``r1_aug_params`` the R1 penalty is added."""
        total, metrics = self.loss_D(self.ctx, self.discriminator, images,
                                     gen_images.detach(), aug_params)
        if r1_aug_params is not None:
            r1 = self.r1(images, r1_aug_params)
            total = total + (0.5 * self.lbd_r1) * r1 * self.d_reg_every
        else:
            r1 = torch.zeros((), device=images.device)
        return total, dict(metrics, D_r1=r1)

    # ------------------------------------------------------------- train

    def train_step(self, images: torch.Tensor, ema_decay: float = 0.0,
                   do_r1: bool = False) -> Metrics:
        """One step on a real batch (uint8 or float NHWC on the device);
        returns detached scalar metrics, still on the device."""
        images = to_float(images)
        if self.real_augment is not None:
            images = self.real_augment.apply(
                images, self.real_augment.sample(images.shape, self.rng))
        n = images.shape[0]

        # 1. EMA with the pre-update parameters
        ema_update(self.g_ema, self.generator, ema_decay)

        # 2. G phase
        draws = self.draw_g(n)
        g_params = list(self.generator.parameters())
        g_loss, gen_images = self.g_loss(
            **draws, aug_params=self.draw_aug(images.shape))
        self.g_tx.step(torch.autograd.grad(g_loss, g_params))

        # 3. D phase on the G phase's fakes
        gen_images = gen_images.detach()
        d_params = list(self.discriminator.parameters())
        with_r1 = do_r1 and self.lbd_r1 > 0
        total, metrics = self.d_loss(
            images, gen_images, self.draw_aug((3 * n,) + images.shape[1:]),
            self.draw_aug(images.shape) if with_r1 else None)
        self.d_tx.step(torch.autograd.grad(total, d_params))

        metrics["G_loss"] = g_loss
        return {k: v.detach() for k, v in metrics.items()}
