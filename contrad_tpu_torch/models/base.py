"""Discriminator head protocol (the port of ``contrad_tpu/models/base.py``).

Every discriminator is a backbone (penultimate feature extractor) plus three
heads: ``linear``, the GAN score head (a 2-layer LeakyReLU(0.1) MLP, the
``mlp_linear=True`` form every registry architecture uses), and
``projection`` / ``projection2``, two 2-layer MLPs for the SimCLR and
supervised-contrastive losses. With ``sg_linear=True`` the GAN head sees
detached features, so the backbone learns only from the contrastive losses
(the ContraD mechanism, reference ``base.py:123-126``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch.ops.spectral_norm import SNDense


class TinyDiscriminatorHead(nn.Module):
    """2-layer GAN score head (reference TinyDiscriminator, base.py:14-35)."""

    def __init__(self, n_features: int, d_hidden: int = 128,
                 use_sn: bool = False):
        super().__init__()
        self.l1 = SNDense(n_features, d_hidden, use_sn=use_sn)
        self.l2 = SNDense(d_hidden, 1, use_sn=use_sn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(F.leaky_relu(self.l1(x), 0.1))


class ProjectionMLP(nn.Module):
    """d_penul -> d_hidden -> d_project with LeakyReLU(0.1) (base.py:92-101)."""

    def __init__(self, n_features: int, d_hidden: int, d_project: int,
                 use_sn: bool = False):
        super().__init__()
        self.fc1 = SNDense(n_features, d_hidden, use_sn=use_sn)
        self.fc2 = SNDense(d_hidden, d_project, use_sn=use_sn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.leaky_relu(self.fc1(x), 0.1))


class Discriminator(nn.Module):
    """Backbone + {linear, projection, projection2} heads. The backbone maps
    an NHWC image batch in [0, 1] to (N, d_penul) features."""

    def __init__(self, backbone: nn.Module, d_penul: int, d_hidden: int = 128,
                 d_project: int = 128, use_sn: bool = False):
        super().__init__()
        self.backbone = backbone
        self.linear = TinyDiscriminatorHead(d_penul, d_hidden, use_sn)
        self.projection = ProjectionMLP(d_penul, d_hidden, d_project, use_sn)
        self.projection2 = ProjectionMLP(d_penul, d_hidden, d_project, use_sn)

    def forward(self, x: torch.Tensor, sg_linear: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (d, aux) with aux = {penultimate, projection, projection2}."""
        feats = self.backbone(x)
        d = self.linear(feats.detach() if sg_linear else feats)
        return d, {"penultimate": feats,
                   "projection": self.projection(feats),
                   "projection2": self.projection2(feats)}


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(x, dim=1) as the JAX package writes it."""
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norm, min=eps)
