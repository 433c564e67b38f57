"""Spectral normalisation with explicit power-iteration state (the port of
``contrad_tpu/ops/spectral_norm.py``: ``spectral_normalize``, ``SNDense``,
``SNConv``, ``SNEmbed``).

The weight, viewed as a 2-D (out, in) matrix, is divided by its leading
singular value, estimated by power iteration from a stored vector ``u``: a
float32 buffer of the output dimension, initialised to a normalised
N(0, 1) draw, one per layer. A forward pass makes two choices:

  * ``train``: one power iteration from the stored ``u``,
    ``v = normalize(Wᵀu)`` and ``u' = normalize(W v)``, both detached, and
    ``sigma = u'·(W v)``, so gradients flow through ``W`` only. Without it
    (eval) ``u`` is used as it is and ``v = normalize(Wᵀu)``;
  * ``persist``: keep the new ``u``. It is staged in the layer, and
    :func:`commit_u` writes it to the buffer once the phase is done. So every
    D pass of a phase, the main pass and the extra passes of a penalty,
    starts from the same stored ``u``, as in the JAX package, where they all
    read the phase's input state and only the main pass returns a new one.

``torch.nn.utils.spectral_norm`` writes ``u`` in place on every training
forward, which advances it once per pass instead of once per phase.

``SNDense`` and ``SNConv`` take a compute dtype (``dtype``, None to keep
the input's): the input and the normalised weight are cast to it, while
``u``, the power iteration and sigma stay in the parameters' float32, as in
the JAX package (``spectral_norm.py:61-73,101-104,139-147``). ``SNEmbed``
has none there and returns the table's dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch import cast

_SN_EPS = 1e-12  # torch.nn.utils.spectral_norm's default eps
_LECUN_TRUNC_STD = 0.87962566103423978  # std of N(0,1) truncated to [-2, 2]

Init = Callable[[torch.Tensor], torch.Tensor]


def lecun_normal_(w: torch.Tensor) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal of variance 1 / fan_in, for
    a torch weight (out, in, ...)."""
    std = math.sqrt(1.0 / w[0].numel()) / _LECUN_TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def dcgan_normal_(w: torch.Tensor) -> torch.Tensor:
    """N(0, 0.02), the DCGAN init (reference ``sndcgan.py:54-66``)."""
    return nn.init.normal_(w, std=0.02)


def _l2_normalize(x: torch.Tensor, eps: float = _SN_EPS) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def spectral_normalize(w2d: torch.Tensor, u: torch.Tensor, update: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w2d / sigma, u')`` for a 2-D (out, in) weight and the stored
    ``u``; ``update`` runs one power iteration (``u' = u`` without)."""
    with torch.no_grad():
        u = u.to(w2d.dtype)
        v = _l2_normalize(torch.mv(w2d.t(), u))
    wv = torch.mv(w2d, v)
    # eval: a copy, so that a later commit into the buffer cannot change a
    # tensor this graph saved for its backward
    u_new = _l2_normalize(wv.detach()) if update else u.clone()
    return w2d / torch.dot(u_new, wv), u_new


class _SpectralState(nn.Module):
    """The ``u`` buffer of one layer and the ``u`` its last persisting
    forward staged."""

    def __init__(self):
        super().__init__()
        self.u_staged: Optional[torch.Tensor] = None

    def _init_u(self, out_dim: int) -> None:
        self.register_buffer("u", _l2_normalize(torch.randn(out_dim)))

    def _normalized(self, w2d: torch.Tensor, train: bool,
                    persist: bool) -> torch.Tensor:
        w2d, u_new = spectral_normalize(w2d, self.u, update=train)
        if train and persist:
            self.u_staged = u_new
        return w2d


@torch.no_grad()
def commit_u(module: nn.Module) -> None:
    """Write into its buffer the ``u`` that each spectral-norm layer of
    ``module`` staged in its last persisting forward (a no-op for layers
    that staged none)."""
    for m in module.modules():
        if isinstance(m, _SpectralState) and m.u_staged is not None:
            m.u.copy_(m.u_staged)
            m.u_staged = None


class SNDense(_SpectralState):
    """``y = x @ W.T + b`` with optional spectral norm (reference: SN'd
    ``nn.Linear``). ``weight`` is (out, in), torch's layout; the JAX
    ``kernel`` is its transpose. Biases start at 0."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 use_sn: bool = True, init: Init = lecun_normal_,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(init(torch.empty(features, in_features)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.use_sn = use_sn
        if use_sn:
            self._init_u(features)

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        w = self.weight
        if self.use_sn:
            w = self._normalized(w, train, persist)
        b = None if self.bias is None else cast(self.bias, self.dtype)
        return F.linear(cast(x, self.dtype), cast(w, self.dtype), b)


class SNConv(_SpectralState):
    """NCHW conv with optional spectral norm (reference: SN'd
    ``nn.Conv2d``). ``weight`` is OIHW, viewed as (O, I*kH*kW) for the
    power iteration; sigma does not depend on the order of the columns, so it
    is the JAX package's (O, kH*kW*I) view's."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 use_sn: bool = True, init: Init = lecun_normal_,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(init(torch.empty(features, in_ch, k, k)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.stride, self.padding = stride, padding
        self.use_sn = use_sn
        if use_sn:
            self._init_u(features)

    def forward(self, x: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        w = self.weight
        if self.use_sn:
            w = self._normalized(w.reshape(w.shape[0], -1), train,
                                 persist).reshape(w.shape)
        b = None if self.bias is None else cast(self.bias, self.dtype)
        return F.conv2d(cast(x, self.dtype), cast(w, self.dtype), b,
                        self.stride, self.padding)


class SNEmbed(_SpectralState):
    """Class embedding with optional spectral norm (reference: SN'd
    ``nn.Embedding``, the conditional discriminator's projection). ``weight``
    is the (num_embeddings, features) table, N(0, 0.02) at the start, the
    JAX ``embedding``; its ``u`` has one entry per class, and is staged and
    committed per phase like the other layers'."""

    def __init__(self, num_embeddings: int, features: int,
                 use_sn: bool = True):
        super().__init__()
        self.weight = nn.Parameter(dcgan_normal_(
            torch.empty(num_embeddings, features)))
        self.use_sn = use_sn
        if use_sn:
            self._init_u(num_embeddings)

    def forward(self, y: torch.Tensor, train: bool = True,
                persist: bool = True) -> torch.Tensor:
        w = self.weight
        if self.use_sn:
            w = self._normalized(w, train, persist)
        return F.embedding(y, w)
