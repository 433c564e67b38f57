"""Discriminator penalties (the port of ``contrad_tpu/training/penalty.py``;
reference ``penalty.py``):

  * ``none`` — zero;
  * ``gp``   — WGAN-GP: ``lbd * E[(|grad_x D(x)| - 1)^2]`` at
               ``x = alpha * real + (1 - alpha) * fake``, a gradient of D
               inside the parameters' gradient;
  * ``cr``   — consistency: ``lbd * E[(D(x) - D(aug(x)))^2]`` on the reals;
  * ``bcr``  — balanced consistency on reals and fakes, ``lbd`` and ``lbd2``.

With a conditional D the penalties' passes score under the labels of the
main pass: ``gp`` and ``cr`` under the real labels, ``bcr`` under the real
and the fake labels, which it takes both or neither.

The penalties' D passes iterate spectral norm from the stored ``u`` but do
not persist it (``persist=False``): the mode's main D pass owns the phase's
one power iteration. Their draws, ``alpha`` and the augmentation's
parameters, are arguments: :func:`sample` makes them.

In a world of processes each rank computes its rows' per-sample terms, and
their means are taken over the global batch (``gather_rows``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from contrad_tpu_torch import at_least_f32
from contrad_tpu_torch.parallel import gather_rows


def sample(kind: str, augment, shape: Tuple[int, ...], rng) -> Any:
    """The penalty's draws for a real batch of ``shape`` (N, H, W, C):
    ``gp`` alpha (N,) in [0, 1); ``cr`` and ``bcr`` the augmentation's
    parameters for the N reals or the 2N reals and fakes; None for
    ``none``."""
    if kind == "none":
        return None
    if kind == "gp":
        return torch.rand(shape[0], generator=rng.device,
                          device=rng.device.device)
    if kind == "cr":
        return augment.sample(tuple(shape), rng)
    if kind == "bcr":
        return augment.sample((2 * shape[0],) + tuple(shape[1:]), rng)
    raise NotImplementedError(f"unknown penalty: {kind}")


def gradient_penalty(D, images, gen_images, alpha, lbd: float, y=None
                     ) -> torch.Tensor:
    n = images.shape[0]
    a = alpha.to(images.dtype)[:, None, None, None]
    interp = (a * images.detach() + (1.0 - a) * gen_images.detach())
    interp.requires_grad_(True)
    d, _ = D(interp, y=y, persist=False)
    (grads,) = torch.autograd.grad(d.sum(), interp, create_graph=True)
    norms = torch.linalg.vector_norm(at_least_f32(grads).reshape(n, -1), dim=1)
    return lbd * gather_rows((norms - 1.0) ** 2).mean()


def consistency(D, images, d_real, augment, params, lbd: float, y=None):
    d_aug, _ = D(augment.apply(images, params), y=y, persist=False)
    return lbd * gather_rows(
        (at_least_f32(d_real) - at_least_f32(d_aug)) ** 2).mean()


def balanced_consistency(D, all_images, d_real, d_gen, augment, params,
                         lbd: float, lbd2: float, y_all=None) -> torch.Tensor:
    d_aug, _ = D(augment.apply(all_images, params), y=y_all, persist=False)
    n = all_images.shape[0] // 2
    d_aug = at_least_f32(d_aug)
    reg_real = gather_rows((at_least_f32(d_real) - d_aug[:n]) ** 2).mean()
    reg_gen = gather_rows((at_least_f32(d_gen) - d_aug[n:]) ** 2).mean()
    return lbd * reg_real + lbd2 * reg_gen


def compute_penalty(ctx, D, *, images, gen_images, all_images, d_real, d_gen,
                    params: Optional[Any], y_real=None, y_gen=None
                    ) -> torch.Tensor:
    """``ctx.penalty`` with ``ctx.lbd`` / ``ctx.lbd2`` and ``ctx.augment``;
    ``all_images`` is the mode's [real, fake] batch that ``bcr`` augments."""
    if ctx.penalty == "none":
        return torch.zeros((), dtype=at_least_f32(d_real).dtype,
                           device=d_real.device)
    if ctx.penalty == "gp":
        return gradient_penalty(D, images, gen_images, params, ctx.lbd,
                                y=y_real)
    if ctx.penalty == "cr":
        return consistency(D, images, d_real, ctx.augment, params, ctx.lbd,
                           y=y_real)
    if ctx.penalty == "bcr":
        if (y_real is None) != (y_gen is None):
            raise ValueError("bcr takes both the real and the fake labels, "
                             "or neither")
        y_all = None if y_real is None else torch.cat([y_real, y_gen])
        return balanced_consistency(D, all_images, d_real, d_gen, ctx.augment,
                                    params, ctx.lbd, ctx.lbd2, y_all=y_all)
    raise NotImplementedError(f"unknown penalty: {ctx.penalty}")
