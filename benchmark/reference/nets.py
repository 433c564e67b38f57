"""The layers that the model families share (``families/``), in plain
PyTorch: functions of a dict of parameters, named as the program's
``state_dict`` names them so that one set of weights serves both, and of
the layers' state (spectral norm's ``u``, batch norm's running
statistics).

Spectral norm: one power iteration a pass from the stored ``u``,
``v = normalise(Wᵀu)``, ``u' = normalise(W v)``, ``sigma = u'·(W v)``, the
gradient through ``W`` alone; ``u'`` is kept once the phase's main pass is
done. Heads (ContraD ``models/gan/base.py``): the GAN score MLP (hidden
width ``d_hidden``, LeakyReLU 0.1) and two projection MLPs to 128,
spectrally normalised where the state holds their ``u``. The FIR layers:
zero insertion, padding and the [1, 3, 3, 1] blur as two 1-D passes
(``upfirdn``), a per-channel 2-D filter, the biased leaky ReLU with gain
sqrt 2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
SQRT2 = math.sqrt(2.0)


def normalise(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def sn_weight(w: torch.Tensor, u: torch.Tensor, staged: Optional[dict],
              key: str) -> torch.Tensor:
    """``w / sigma`` by one power iteration from ``u``; the new ``u`` goes
    to ``staged[key]`` where ``staged`` is given."""
    w2 = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = normalise(w2.t() @ u)
    wv = w2 @ v
    u_new = normalise(wv.detach())
    if staged is not None:
        staged[key] = u_new
    return (w2 / torch.dot(u_new, wv)).reshape(w.shape)


def batch_norm(x, p: Params, state: Params, key: str, momentum=0.9,
               eps=1e-5):
    dims = [0] + list(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    with torch.no_grad():
        state[key + ".running_mean"].mul_(momentum).add_(
            (1 - momentum) * mean)
        state[key + ".running_var"].mul_(momentum).add_((1 - momentum) * var)
    shape = [1, -1] + [1] * (x.dim() - 2)
    xh = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return xh * p[key + ".weight"].reshape(shape) + p[key + ".bias"].reshape(
        shape)


def dense(x, p: Params, key: str, state: Optional[Params] = None,
          staged: Optional[dict] = None):
    """``x Wᵀ + b``; spectrally normalised where ``state`` holds a ``u``."""
    w = p[key + ".weight"]
    if state is not None and key + ".u" in state:
        w = sn_weight(w, state[key + ".u"], staged, key + ".u")
    return F.linear(x, w, p.get(key + ".bias"))


def l2_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def heads(feats, p: Params, state: Params, staged, sg_linear: bool):
    """(GAN score, projection, projection2) of the features."""
    f_lin = feats.detach() if sg_linear else feats
    h = F.leaky_relu(dense(f_lin, p, "linear.l1", state, staged), 0.1)
    d = dense(h, p, "linear.l2", state, staged)

    def mlp(name):
        h = F.leaky_relu(dense(feats, p, name + ".fc1", state, staged), 0.1)
        return dense(h, p, name + ".fc2", state, staged)

    return d, mlp("projection"), mlp("projection2")


def head_spec(n_features: int, d_hidden: int, init) -> list:
    spec = []
    for name, (i, o) in (("linear.l1", (n_features, d_hidden)),
                         ("linear.l2", (d_hidden, 1)),
                         ("projection.fc1", (n_features, d_hidden)),
                         ("projection.fc2", (d_hidden, 128)),
                         ("projection2.fc1", (n_features, d_hidden)),
                         ("projection2.fc2", (d_hidden, 128))):
        spec += [(name + ".weight", (o, i), init(i)),
                 (name + ".bias", (o,), ("zeros",))]
    return spec


def bn_spec(key: str, n: int) -> list:
    return [(key + ".weight", (n,), ("ones",)), (key + ".bias", (n,), ("zeros",)),
            (key + ".running_mean", (n,), ("zeros",)),
            (key + ".running_var", (n,), ("ones",))]



BLUR_1D = (0.125, 0.375, 0.375, 0.125)  # [1, 3, 3, 1] / 8; the blur is its outer square


def upfirdn(x: torch.Tensor, up: int, pad: Tuple[int, int],
            gain: float = 1.0) -> torch.Tensor:
    """NCHW: insert ``up - 1`` zeros after each sample, pad both spatial
    dims by ``pad`` (negative crops), correlate each channel with the 4x4
    blur times ``gain``, as its two 1-D factors: sums of shifted slices,
    whose gradient of a gradient (R1's) is as plain as their forward."""
    if up > 1:
        n, c, h, w = x.shape
        z = x.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    taps = [t * math.sqrt(gain) for t in BLUR_1D]
    return fir(fir(x, taps, 2), taps, 3)


def fir(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Correlation of ``x`` with ``taps`` along ``dim`` (valid part)."""
    n = x.shape[dim] - len(taps) + 1
    out = taps[0] * x.narrow(dim, 0, n)
    for i, t in enumerate(taps[1:], 1):
        out = out + t * x.narrow(dim, i, n)
    return out


def per_channel(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each channel of NCHW ``x`` correlated with the 2-D filter ``k``, one
    channel an image."""
    n, c, h, w = x.shape
    y = F.conv2d(x.reshape(n * c, 1, h, w), k[None, None])
    return y.reshape(n, c, y.shape[2], y.shape[3])


def lrelu(x, bias):
    return F.leaky_relu(x + bias.reshape(1, -1, 1, 1), 0.2) * SQRT2
