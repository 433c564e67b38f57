"""The train steps (the port of ``contrad_tpu/training/step.py``:
``GANTrainer._step`` and ``StyleGAN2Trainer._sg2_step``).

:class:`GANTrainer`, ``train_gan.py``'s step (reference
``train_gan.py:124-227``):
  1. ``n_critic`` D sub-steps, each on a fresh real batch and fresh fakes:
     G runs in train mode under ``no_grad`` (its batch-norm statistics
     advance), then the mode's D loss, one Adam update of D, and D's
     spectral-norm ``u`` committed;
  2. one G update on fresh z against the updated D, which runs in train
     mode there, so its ``u`` advances again;
  3. optionally (``ema``) an EMA of G's parameters after the update, its
     buffers copied.
With a StyleGAN2 G (``train_gan`` on a ``stylegan2*`` architecture) each G
forward draws its noise maps and its style mixing, as the JAX trainer's G
does with its default probability of 0.9; a StyleGAN3 G draws its latents
alone (``G.draws``), and each of its forwards in train mode updates its EMA
buffers (``w_avg``, the magnitude EMAs) in place, inside a step's CUDA
graph too; the EMA G copies them with its parameters' EMA.

:class:`StyleGAN2Trainer`, ``train_stylegan2.py``'s (reference
``train_stylegan2.py:163-229``):
  1. EMA of G with the PRE-update parameters;
  2. the G phase first: fresh z, noise and style mixing, augmented fakes,
     the mode's G loss, one Adam update of G;
  3. the D phase on the G phase's (detached, pre-update) fakes: the mode's D
     loss with its penalty (``gp``, ``cr``, ``bcr``) plus, when ``do_r1``,
     the R1 penalty on augmented detached reals scaled by
     ``0.5 * lbd_r1 * d_reg_every``; one Adam update of D;
  4. ``n_critic - 1`` more D sub-steps as in :class:`GANTrainer`.
R1 is a gradient of a gradient through D, so the blur kernel's
``autograd.Function`` runs forward, backward and double backward there.

A conditional D (``n_classes > 1``, ``train_gan --conditional``) takes the
real batch's labels in :meth:`GANTrainer.train_step`; the fakes' labels are
drawn uniformly from ``[0, n_classes)``, one per fake, in each D sub-step
and in the G phase (reference ``train_gan.py:124-227``; G itself is
unconditional). An unconditional D ignores labels. The StyleGAN2 trainer is
unconditional, as in the JAX package.

Every random draw comes from the trainer's :class:`AugRng`, and every draw
can be passed in instead (``train_step(..., draws=)``, the phases' and the
phase losses' arguments), so the tests can feed the draws JAX made. A step
never waits on the device: its metrics stay there until the caller reads
them.

In a world of processes (``parallel/``) a step computes the global batch's
function, the one a world of one computes: each rank takes its rows of the
batch, ``draw_step`` draws the global step's draws on every rank from the
shared generator and keeps this rank's rows of each per-sample draw
(:func:`~contrad_tpu_torch.parallel.mesh.local_rows`; a per-batch draw stays
whole), the losses are global (``modes.py``), and the gradients are summed
over the world before each optimiser steps. So the generator, the
parameters, the optimisers and the metrics are the same on every rank.

A step is cut into named phases (``utils/trace.py``): ``step`` around it
all, ``d`` each D update, ``r1`` inside it, ``g`` the G update, ``aug``
each application of an augment, and ``update`` each Adam update with its
``u`` commit and the EMA. On the card each phase is marked by kernels that
a CUDA graph of the step captures with the rest.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from contrad_tpu_torch import at_least_f32
from contrad_tpu_torch.augment import AugRng, traced
from contrad_tpu_torch.ops.spectral_norm import commit_u
from contrad_tpu_torch.parallel import (
    all_reduce_grads, data_shard, gather_rows)
from contrad_tpu_torch.parallel.mesh import local_rows
from contrad_tpu_torch.training.modes import Draws, ModeCtx, draw_d, get_mode
from contrad_tpu_torch.training.state import ScheduledAdam, ema_update
from contrad_tpu_torch.utils.trace import phase

Metrics = Dict[str, torch.Tensor]


def to_float(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> ``dtype`` [0, 1]; under a bfloat16
    compute dtype straight to bfloat16, as the JAX step converts
    (``step.py:85-94``)."""
    if images.dtype == torch.uint8:
        return images.to(dtype) / 255.0
    return images.to(dtype)


def _grads(loss: torch.Tensor, module: torch.nn.Module):
    """d loss / d each parameter of ``module``; zeros for the parameters the
    loss does not reach (a head the mode leaves unused), as in JAX. In a
    world, summed over the ranks (``all_reduce_grads``)."""
    return all_reduce_grads(torch.autograd.grad(
        loss, list(module.parameters()), allow_unused=True,
        materialize_grads=True))


class StepDraws(NamedTuple):
    """Every random draw of one :meth:`GANTrainer.train_step`."""

    real: Any  # the real augmentation's parameters (None without one)
    critic: List[Tuple[Dict[str, Any], Draws]]  # per D sub-step: G, D loss
    g: Tuple[Dict[str, Any], Any]  # the G phase: G's draws, its augmentation
    r1: Any = None  # StyleGAN2: R1's augmentation of the reals (None: no R1)
    # conditional D: the fakes' labels of each D sub-step, then of the G
    # phase (None: unconditional)
    y_gen: Optional[List[torch.Tensor]] = None


class GANTrainer:
    """Owns G, D, both optimisers, the optional EMA copy of G and the random
    streams. ``g_optimizer`` and ``d_optimizer`` take a list of gradients,
    one per parameter, in ``step``."""

    def __init__(self, generator, discriminator, mode: str, augment,
                 g_optimizer: ScheduledAdam, d_optimizer: ScheduledAdam,
                 loss_type: str, penalty: str = "none", temp: float = 0.1,
                 lbd_a: float = 1.0, lbd: float = 10.0, lbd2: float = 10.0,
                 n_critic: int = 1, ema: bool = False, real_augment=None,
                 seed: int = 0):
        self.generator = generator
        self.discriminator = discriminator
        self.g_ema = (copy.deepcopy(generator).requires_grad_(False) if ema
                      else None)
        self.g_tx, self.d_tx = g_optimizer, d_optimizer
        self.ctx = ModeCtx(traced(augment), loss_type, temp, lbd_a, penalty,
                           lbd, lbd2)
        self.mode = get_mode(mode)
        self.loss_D, self.loss_G = self.mode.loss_D, self.mode.loss_G
        self.n_critic = n_critic
        self.real_augment = traced(real_augment)
        # the step's image dtype: D's compute dtype (the JAX package's
        # image_dtype, step.py:144-147), else its parameters' (float32, or
        # float64 where the parity tests make the models double)
        self.dtype = (getattr(discriminator, "dtype", None)
                      or next(discriminator.parameters()).dtype)
        self.device = next(generator.parameters()).device
        self.rng = AugRng.from_seed(seed, self.device)
        self.n_classes = discriminator.n_classes
        self.conditional = self.n_classes > 1
        # a StyleGAN2 G's mixing probability where the JAX trainer passes
        # none: its G's default (models/stylegan2/generator.py:343)
        self.style_mix = 0.9

    # ------------------------------------------------------------- state

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs of the trainer: G, D and the EMA G
        with their buffers (spectral norm's ``u``, G's batch-norm
        statistics), both optimisers and the random stream."""
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "g_ema": (None if self.g_ema is None
                          else self.g_ema.state_dict()),
                "g_optimizer": self.g_tx.state_dict(),
                "d_optimizer": self.d_tx.state_dict(),
                "rng": {"device": self.rng.device.get_state()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.generator.load_state_dict(state["generator"])
        self.discriminator.load_state_dict(state["discriminator"])
        if self.g_ema is not None:
            self.g_ema.load_state_dict(state["g_ema"])
        self.g_tx.load_state_dict(state["g_optimizer"])
        self.d_tx.load_state_dict(state["d_optimizer"])
        self.rng.device.set_state(state["rng"]["device"].cpu())

    # ------------------------------------------------------------- draws

    def draw_g(self, n: int) -> Dict[str, Any]:
        """The draws of one G forward, as G asks for them (``draws``): a
        StyleGAN2 G's latents, per-layer noise and style mixing, a StyleGAN3
        G's latents alone; else the latents."""
        g, G = self.rng.device, self.generator
        if hasattr(G, "draws"):
            return G.draws(n, g, self.style_mix)
        return {"z": G.sample_latent(n, g)}

    def draw_aug(self, shape):
        return self.ctx.augment.sample(tuple(shape), self.rng)

    def draw_d(self, shape) -> Draws:
        """The draws of one D loss on a real batch of ``shape``."""
        return draw_d(self.mode, self.ctx, tuple(shape), self.rng)

    def draw_y(self, n: int) -> torch.Tensor:
        """``n`` fake labels, uniform in ``[0, n_classes)``."""
        return torch.randint(0, self.n_classes, (n,), generator=self.rng.device,
                             device=self.device)

    def draw_g_aug(self, shape):
        """The G loss's augmentation of a fake batch of ``shape``."""
        return self.draw_aug(shape) if self.mode.g_aug else None

    def draw_step(self, shape, **kwargs) -> StepDraws:
        """All draws of one step on this rank's real batch of ``shape``
        (n_critic * N, H, W, C): the global step's draws (:meth:`
        draw_global`), of which this rank keeps its rows."""
        world = data_shard()[1]
        shape = (shape[0] * world,) + tuple(shape[1:])
        return local_rows(self.draw_global(shape, **kwargs),
                          shape[0] // self.n_critic)

    def draw_global(self, shape) -> StepDraws:
        """All draws of one step on a global real batch of ``shape``
        (n_critic * N, H, W, C)."""
        real = (self.real_augment.sample(tuple(shape), self.rng)
                if self.real_augment is not None else None)
        batch = (shape[0] // self.n_critic,) + tuple(shape[1:])
        critic = [(self.draw_g(batch[0]), self.draw_d(batch))
                  for _ in range(self.n_critic)]
        g = (self.draw_g(batch[0]), self.draw_g_aug(batch))
        y_gen = ([self.draw_y(batch[0]) for _ in range(self.n_critic + 1)]
                 if self.conditional else None)
        return StepDraws(real, critic, g, y_gen=y_gen)

    # ------------------------------------------------------------- phases

    def d_substep(self, images, g_draws: Dict[str, Any], draws: Draws,
                  y_real=None, y_gen=None) -> Metrics:
        """One D update on ``images`` (labelled ``y_real`` for a conditional
        D) and fresh fakes (labelled ``y_gen``; G in train mode, its
        batch-norm statistics advancing); D's ``u`` committed."""
        with phase("d", self.device):
            with torch.no_grad():
                gen_images = self.generator(**g_draws, train=True)
            total, metrics = self.loss_D(self.ctx, self.discriminator, images,
                                         gen_images, draws, y_real, y_gen)
            grads = _grads(total, self.discriminator)
        self.update(self.d_tx, grads)
        return metrics

    def g_update(self, g_draws: Dict[str, Any], aug_params, y_gen=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One G update against the current D, whose ``u`` advances;
        returns the loss and the (pre-update) fakes."""
        with phase("g", self.device):
            gen_images = self.generator(**g_draws, train=True)
            loss = self.loss_G(self.ctx, self.discriminator, gen_images,
                               aug_params, y_gen)
            grads = _grads(loss, self.generator)
        self.update(self.g_tx, grads)
        return loss, gen_images

    def update(self, tx: ScheduledAdam, grads) -> None:
        """One Adam update of ``tx``'s parameters and D's ``u`` committed
        (the ``update`` phase)."""
        with phase("update", self.device):
            tx.step(grads)
            commit_u(self.discriminator)

    def ema(self, decay: float | torch.Tensor) -> None:
        """The EMA of G's parameters, its buffers copied (an ``update``
        phase)."""
        with phase("update", self.device):
            ema_update(self.g_ema, self.generator, decay)

    # ------------------------------------------------------------- train

    def train_step(self, images: torch.Tensor,
                   ema_decay: float | torch.Tensor = 0.0,
                   draws: Optional[StepDraws] = None,
                   labels: Optional[torch.Tensor] = None) -> Metrics:
        """One step on ``n_critic`` real batches (uint8 or float NHWC on the
        device, stacked) and, for a conditional D, their ``labels``;
        returns the last D sub-step's metrics and ``G_loss``, detached,
        still on the device. ``ema_decay`` is a number or a device scalar
        (a CUDA graph of the step reads each replay's there)."""
        if self.conditional and labels is None:
            raise ValueError("the discriminator has n_classes > 1: pass labels")
        with phase("step", self.device):
            images = to_float(images, self.dtype)
            if draws is None:
                draws = self.draw_step(images.shape)
            if self.real_augment is not None:
                images = self.real_augment.apply(images, draws.real)
            n = images.shape[0] // self.n_critic
            y_real = (labels.split(n) if self.conditional
                      else [None] * self.n_critic)
            y_gen = draws.y_gen or [None] * (self.n_critic + 1)
            for batch, (g_draws, d_draws), yr, yg in zip(
                    images.split(n), draws.critic, y_real, y_gen[:-1],
                    strict=True):
                metrics = self.d_substep(batch, g_draws, d_draws, yr, yg)
            metrics["G_loss"], _ = self.g_update(*draws.g, y_gen[-1])
            if self.g_ema is not None:
                self.ema(ema_decay)
            return {k: v.detach() for k, v in metrics.items()}


class StyleGAN2Trainer(GANTrainer):
    """``train_stylegan2.py`` semantics (see the module docstring); always
    keeps an EMA copy of G."""

    def __init__(self, generator, discriminator, mode: str, augment,
                 g_optimizer: ScheduledAdam, d_optimizer: ScheduledAdam,
                 loss_type: str, penalty: str = "none", temp: float = 0.1,
                 lbd_a: float = 1.0, lbd: float = 10.0, lbd2: float = 10.0,
                 lbd_r1: float = 10.0, d_reg_every: int = 16,
                 style_mix: float = 0.9, n_critic: int = 1,
                 real_augment=None, seed: int = 0):
        super().__init__(generator, discriminator, mode, augment, g_optimizer,
                         d_optimizer, loss_type, penalty=penalty, temp=temp,
                         lbd_a=lbd_a, lbd=lbd, lbd2=lbd2, n_critic=n_critic,
                         ema=True, real_augment=real_augment, seed=seed)
        if self.conditional:
            raise NotImplementedError(
                "the StyleGAN2 trainer is unconditional, as in the JAX "
                "package")
        self.lbd_r1 = lbd_r1
        self.d_reg_every = d_reg_every
        self.style_mix = style_mix

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
        parameters. The D pass does not persist D's state."""
        with phase("r1", self.device):
            x = self.ctx.augment.apply(images, aug_params).detach()
            x.requires_grad_(True)
            d, _ = self.discriminator(x, persist=False)
            (grads,) = torch.autograd.grad(d.sum(), x, create_graph=True)
            return gather_rows(at_least_f32(grads).reshape(x.shape[0], -1)
                               .pow(2).sum(dim=1)).mean()

    def d_loss(self, images, gen_images, draws: Draws,
               r1_aug_params: Optional[Any] = None
               ) -> Tuple[torch.Tensor, Metrics]:
        """D-phase loss with its penalty (``draws``: the mode's augmentation
        of the D batch and the penalty's draws); with ``r1_aug_params`` the
        R1 penalty is added."""
        total, metrics = self.loss_D(self.ctx, self.discriminator, images,
                                     gen_images.detach(), draws)
        if r1_aug_params is not None:
            r1 = self.r1(images, r1_aug_params)
            total = total + (0.5 * self.lbd_r1) * r1 * self.d_reg_every
        else:
            r1 = torch.zeros((), device=images.device)
        return total, dict(metrics, D_r1=r1)

    # ------------------------------------------------------------- train

    def draw_global(self, shape, with_r1: bool = False) -> StepDraws:
        """All draws of one step on a global real batch of ``shape``
        (n_critic * N, H, W, C). The first D sub-step reuses the G phase's
        fakes, so its G draws are None."""
        draws = super().draw_global(shape)
        (_, first), *others = draws.critic
        batch = (shape[0] // self.n_critic,) + tuple(shape[1:])
        return draws._replace(critic=[(None, first)] + others,
                              r1=self.draw_aug(batch) if with_r1 else None)

    def train_step(self, images: torch.Tensor,
                   ema_decay: float | torch.Tensor = 0.0,
                   do_r1: bool = False, draws: Optional[StepDraws] = None
                   ) -> Metrics:
        """One step on ``n_critic`` real batches (uint8 or float NHWC on the
        device, stacked); returns detached scalar metrics, still on the
        device: the last D sub-step's, R1 from the regularised pass, and
        ``G_loss``. R1 runs where the draws hold its augmentation: with
        ``draws`` None, where ``do_r1`` and ``lbd_r1 > 0``."""
        with phase("step", self.device):
            images = to_float(images, self.dtype)
            if draws is None:
                draws = self.draw_step(images.shape,
                                       with_r1=do_r1 and self.lbd_r1 > 0)
            if self.real_augment is not None:
                images = self.real_augment.apply(images, draws.real)
            batches = images.split(images.shape[0] // self.n_critic)

            # 1. EMA with the pre-update parameters
            self.ema(ema_decay)

            # 2. G phase
            g_loss, gen_images = self.g_update(*draws.g)

            # 3. D phase on the G phase's fakes
            (_, d_draws), *others = draws.critic
            with phase("d", self.device):
                total, metrics = self.d_loss(batches[0], gen_images.detach(),
                                             d_draws, draws.r1)
                grads = _grads(total, self.discriminator)
            self.update(self.d_tx, grads)

            # 4. the other critic steps, with fresh batches and fakes
            for batch, (g_draws, d_draws) in zip(batches[1:], others,
                                                 strict=True):
                metrics = dict(self.d_substep(batch, g_draws, d_draws),
                               D_r1=metrics["D_r1"])
            metrics["G_loss"] = g_loss
            return {k: v.detach() for k, v in metrics.items()}
