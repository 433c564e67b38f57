"""Discriminator head protocol (the port of ``contrad_tpu/models/base.py``).

Every discriminator is a backbone (penultimate feature extractor) plus three
heads: ``linear``, the GAN score head (a plain spectrally normalised linear
layer, the JAX default ``mlp_linear=False``; or a 2-layer LeakyReLU(0.1)
MLP, the ``mlp_linear=True`` form every registry architecture uses), and
``projection`` / ``projection2``, two 2-layer MLPs for the SimCLR and
supervised-contrastive losses. With ``sg_linear=True`` the GAN head sees
detached features, so the backbone learns only from the contrastive losses
(the ContraD mechanism, reference ``base.py:123-126``).

A conditional discriminator (``n_classes > 1``) adds projection
discrimination to the GAN head: ``d + sum(h * embed(y))``, ``h`` the MLP
head's hidden activation (the features themselves for the linear head) and
``embed`` the spectrally normalised class table
``linear.linear_y`` (reference ``base.py:107-130``). Without labels it
scores as an unconditional one.

``train`` and ``persist`` reach every spectral-norm layer (backbone and
heads): ``train`` runs one power iteration, ``persist`` stages its new ``u``
for :func:`contrad_tpu_torch.ops.spectral_norm.commit_u`; the analogue of the
JAX package's ``update_state`` (``training/step.py::make_d_apply``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch.ops.spectral_norm import (
    Init, SNDense, SNEmbed, lecun_normal_)


class TinyDiscriminatorHead(nn.Module):
    """2-layer GAN score head (reference TinyDiscriminator, base.py:14-35),
    with the class projection ``linear_y`` where ``n_classes > 1``."""

    def __init__(self, n_features: int, d_hidden: int = 128,
                 use_sn: bool = False, init: Init = lecun_normal_,
                 n_classes: int = 1):
        super().__init__()
        self.l1 = SNDense(n_features, d_hidden, use_sn=use_sn, init=init)
        self.l2 = SNDense(d_hidden, 1, use_sn=use_sn, init=init)
        self.linear_y = (SNEmbed(n_classes, d_hidden, use_sn=use_sn)
                         if n_classes > 1 else None)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = True, persist: bool = True) -> torch.Tensor:
        h = F.leaky_relu(self.l1(x, train, persist), 0.1)
        d = self.l2(h, train, persist)
        if y is not None:
            if self.linear_y is None:
                raise ValueError("an unconditional head takes no labels")
            w_y = self.linear_y(y, train, persist)
            d = d + torch.sum(h * w_y, dim=1, keepdim=True)
        return d


class LinearDiscriminatorHead(nn.Module):
    """Plain linear GAN score head (reference LinearDiscriminator,
    base.py:38-54), with the class projection ``linear_y`` of the features
    where ``n_classes > 1``."""

    def __init__(self, n_features: int, use_sn: bool = False,
                 init: Init = lecun_normal_, n_classes: int = 1):
        super().__init__()
        self.linear = SNDense(n_features, 1, use_sn=use_sn, init=init)
        self.linear_y = (SNEmbed(n_classes, n_features, use_sn=use_sn)
                         if n_classes > 1 else None)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = True, persist: bool = True) -> torch.Tensor:
        d = self.linear(x, train, persist)
        if y is not None:
            if self.linear_y is None:
                raise ValueError("an unconditional head takes no labels")
            w_y = self.linear_y(y, train, persist)
            d = d + torch.sum(x * w_y, dim=1, keepdim=True)
        return d


class ProjectionMLP(nn.Module):
    """d_penul -> d_hidden -> d_project with LeakyReLU(0.1) (base.py:92-101)."""

    def __init__(self, n_features: int, d_hidden: int, d_project: int,
                 use_sn: bool = False, init: Init = lecun_normal_):
        super().__init__()
        self.fc1 = SNDense(n_features, d_hidden, use_sn=use_sn, init=init)
        self.fc2 = SNDense(d_hidden, d_project, use_sn=use_sn, init=init)

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(x, train, persist), 0.1)
        return self.fc2(h, train, persist)


class Discriminator(nn.Module):
    """Backbone + {linear, projection, projection2} heads. The backbone maps
    an NHWC image batch in [0, 1] to (N, d_penul) features and takes
    ``train`` and ``persist`` as the heads do. ``mlp_linear`` picks the GAN
    head: the 2-layer MLP, or (False, the JAX default) the linear head.
    ``head_init`` initialises the heads' weights (lecun-normal, or
    N(0, 0.02) for SNDCGAN)."""

    def __init__(self, backbone: nn.Module, d_penul: int, d_hidden: int = 128,
                 d_project: int = 128, use_sn: bool = False,
                 head_init: Init = lecun_normal_, n_classes: int = 1,
                 mlp_linear: bool = False):
        super().__init__()
        self.backbone = backbone
        self.d_penul = d_penul
        self.n_classes = n_classes
        self.linear = (
            TinyDiscriminatorHead(d_penul, d_hidden, use_sn, head_init,
                                  n_classes) if mlp_linear
            else LinearDiscriminatorHead(d_penul, use_sn, head_init,
                                         n_classes))
        self.projection = ProjectionMLP(d_penul, d_hidden, d_project, use_sn,
                                        head_init)
        self.projection2 = ProjectionMLP(d_penul, d_hidden, d_project, use_sn,
                                         head_init)

    @property
    def dtype(self) -> Optional[torch.dtype]:
        """The backbone's compute dtype (None: the parameters' own), the
        dtype of the images the trainers feed D; the heads run in float32
        on the backbone's float32 features."""
        return self.backbone.dtype

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                sg_linear: bool = False, train: bool = True,
                persist: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (d, aux) with aux = {penultimate, projection, projection2};
        ``y``, the class labels, reaches the GAN head of a conditional D."""
        feats = self.backbone(x, train, persist)
        d = self.linear(feats.detach() if sg_linear else feats, y, train,
                        persist)
        return d, {"penultimate": feats,
                   "projection": self.projection(feats, train, persist),
                   "projection2": self.projection2(feats, train, persist)}


class LinearClassifier(nn.Module):
    """Linear probe head for representation evaluation (reference
    LinearWrapper, base.py:56-61)."""

    def __init__(self, n_features: int, n_classes: int):
        super().__init__()
        self.linear = nn.Linear(n_features, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class NullDiscriminator(nn.Module):
    """Identity-score D: sums each sample's inputs (reference
    base.py:64-70)."""

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = True, persist: bool = True) -> torch.Tensor:
        return torch.sum(x.reshape(x.shape[0], -1), dim=1, keepdim=True)


def projection(discriminator: Discriminator, inputs: torch.Tensor,
               train: bool = True, persist: bool = True) -> torch.Tensor:
    """The (un-normalised) projection head's output of a D pass (reference
    base.py:73-76). The D's state is its modules': with ``train`` and
    ``persist`` the pass stages spectral norm's ``u`` for
    :func:`~contrad_tpu_torch.ops.spectral_norm.commit_u`."""
    return discriminator(inputs, train=train, persist=persist)[1]["projection"]


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(x, dim=1) as the JAX package writes it."""
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norm, min=eps)
