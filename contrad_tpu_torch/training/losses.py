"""GAN and contrastive losses (the port of ``contrad_tpu/training/losses.py``:
``nt_xent``, ``supcon_fake``, and the ``nonsat`` GAN losses). The loss math
is float32, and self-similarity is masked with -5e4 as in the reference."""

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
    if loss_type != "nonsat":
        raise NotImplementedError(f"GAN loss {loss_type!r} is not ported yet")
    return (F.softplus(at_least_f32(d_gen)).mean()
            + F.softplus(-at_least_f32(d_real)).mean())


def gan_g_loss(d_gen: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Generator GAN loss (reference ``std.py:40-48``)."""
    if loss_type != "nonsat":
        raise NotImplementedError(f"GAN loss {loss_type!r} is not ported yet")
    return F.softplus(-at_least_f32(d_gen)).mean()
