"""GAN and contrastive losses (the port of ``contrad_tpu/training/losses.py``:
``nt_xent``, ``supcon_fake``, and the ``nonsat``, ``wgan``, ``hinge`` and
``lsgan`` GAN losses). The loss math is at least float32, and
self-similarity is masked with -5e4 as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contrad_tpu_torch import at_least_f32
from contrad_tpu_torch.models.base import l2_normalize_rows

NEG_INF_DIAG = -5e4  # reference masks self-similarity with -5e4


def nt_xent(out1: torch.Tensor, out2: torch.Tensor, temperature: float = 0.1,
            normalize: bool = False) -> torch.Tensor:
    """SimCLR NT-Xent over two views (reference ``criterion.py:24-45``)."""
    if out1.shape[0] != out2.shape[0]:
        raise ValueError("nt_xent takes two views of the same batch")
    out1, out2 = at_least_f32(out1), at_least_f32(out2)
    if normalize:
        out1, out2 = l2_normalize_rows(out1), l2_normalize_rows(out2)
    n = out1.shape[0]
    outputs = torch.cat([out1, out2], dim=0)
    sim = outputs @ outputs.t() / temperature
    eye = torch.eye(2 * n, dtype=torch.bool, device=sim.device)
    log_sm = F.log_softmax(sim.masked_fill(eye, NEG_INF_DIAG), dim=1)
    pos12 = torch.diagonal(log_sm[:n, n:])
    pos21 = torch.diagonal(log_sm[n:, :n])
    return -(pos12.sum() + pos21.sum()) / (2 * n)


def supcon_fake(out1: torch.Tensor, out2: torch.Tensor, others: torch.Tensor,
                temperature: float) -> torch.Tensor:
    """Supervised-contrastive loss with the fakes as one class (reference
    ``contrad.py:8-32``): rows are the fakes, positives the other fakes,
    negatives both real views."""
    out1, out2, others = map(at_least_f32, (out1, out2, others))
    n, m = out1.shape[0], others.shape[0]
    outputs = torch.cat([out1, out2, others], dim=0)
    total = 2 * n + m
    sim = outputs @ outputs.t() / temperature
    eye = torch.eye(total, dtype=torch.bool, device=sim.device)
    sim = sim.masked_fill(eye, NEG_INF_DIAG)
    cols = torch.arange(total, device=sim.device)
    rows = torch.arange(m, device=sim.device) + 2 * n
    mask = ((cols[None, :] >= 2 * n) & (cols[None, :] != rows[:, None])).to(sim.dtype)
    mask = mask / mask.sum(dim=1, keepdim=True)
    log_sm = F.log_softmax(sim[2 * n:], dim=1)
    return -torch.mean(torch.sum(log_sm * mask, dim=1))


def gan_d_loss(d_real: torch.Tensor, d_gen: torch.Tensor,
               loss_type: str) -> torch.Tensor:
    """Discriminator GAN loss (reference ``std.py:14-25``)."""
    d_real, d_gen = at_least_f32(d_real), at_least_f32(d_gen)
    if loss_type == "nonsat":
        return F.softplus(d_gen).mean() + F.softplus(-d_real).mean()
    if loss_type == "wgan":
        return d_gen.mean() - d_real.mean()
    if loss_type == "hinge":
        return F.relu(1.0 + d_gen).mean() + F.relu(1.0 - d_real).mean()
    if loss_type == "lsgan":
        return 0.5 * (((d_real - 1.0) ** 2).mean() + (d_gen ** 2).mean())
    raise NotImplementedError(f"unknown GAN loss: {loss_type}")


def gan_g_loss(d_gen: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Generator GAN loss (reference ``std.py:40-48``): nonsat and lsgan have
    their own forms, every other loss uses -E[d_gen]."""
    d_gen = at_least_f32(d_gen)
    if loss_type == "nonsat":
        return F.softplus(-d_gen).mean()
    if loss_type == "lsgan":
        return 0.5 * ((d_gen - 1.0) ** 2).mean()
    return -d_gen.mean()
