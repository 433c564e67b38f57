"""SNDCGAN (Miyato et al. 2018; ContraD ``models/gan/sndcgan.py``) with
ContraD's discriminator heads, spectrally normalised; it follows the
``train_gan`` critic loop (``step = "critic"``) and runs neither the blur
nor the fused activation.

  G: z (U(-1, 1)^128) -> dense -> BN -> ReLU -> 3 x (4x4/2 transposed conv,
     BN, ReLU) -> 3x3 conv -> tanh, rescaled to [0, 1]; BN in train mode
     normalises with the batch's biased variance, running statistics move by
     0.1 of the batch's.
  D: x * 2 - 1 -> 7 spectrally normalised convs, LeakyReLU(0.1) -> the
     features flattened (h, w, c).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.families import Family
from benchmark.reference.nets import (
    Params, batch_norm, bn_spec, head_spec, heads, sn_weight)


class SNDCGAN(Family):
    """``cfg``: ``image_size``, ``ngf``, ``ndf``, ``nz``, ``d_hidden``."""

    step = "critic"
    buffers = (".u", ".running_mean", ".running_var")

    def __init__(self, cfg: dict):
        self.size = cfg["image_size"]
        self.ngf, self.ndf, self.nz = cfg["ngf"], cfg["ndf"], cfg["nz"]
        self.d_hidden = cfg["d_hidden"]
        f = self.ndf
        self.d_layers = ((3, f, 3, 1), (f, 2 * f, 4, 2), (2 * f, 2 * f, 3, 1),
                         (2 * f, 4 * f, 4, 2), (4 * f, 4 * f, 3, 1),
                         (4 * f, 8 * f, 4, 2), (8 * f, 8 * f, 3, 1))

    def g_spec(self) -> list:
        g, s = self.ngf, self.size // 8
        width = 8 * g * s * s
        n02 = ("normal", 0.02)
        spec = [("linear.weight", (width, self.nz), n02),
                ("linear.bias", (width,), ("zeros",))]
        spec += bn_spec("norm_init", width)
        chans = (8 * g, 4 * g, 2 * g, g)
        for i in range(3):
            spec += [(f"up{i}.weight", (chans[i], chans[i + 1], 4, 4), n02),
                     (f"up{i}.bias", (chans[i + 1],), ("zeros",))]
            spec += bn_spec(f"norm{i}", chans[i + 1])
        spec += [("to_rgb.weight", (3, g, 3, 3), n02),
                 ("to_rgb.bias", (3,), ("zeros",))]
        return spec

    def d_spec(self) -> list:
        n02 = ("normal", 0.02)
        spec = []
        for i, (cin, cout, k, _) in enumerate(self.d_layers):
            spec += [(f"backbone.c{i}.weight", (cout, cin, k, k), n02),
                     (f"backbone.c{i}.bias", (cout,), ("zeros",)),
                     (f"backbone.c{i}.u", (cout,), ("unit",))]
        for name, shape, init in head_spec(self.n_features, self.d_hidden,
                                           lambda i: n02):
            spec.append((name, shape, init))
            if name.endswith(".weight"):
                spec.append((name[:-len("weight")] + "u", shape[:1], ("unit",)))
        return spec

    @property
    def n_features(self) -> int:
        return 8 * self.ndf * (self.size // 8) ** 2

    def sample_z(self, n: int, r) -> Dict:
        return {"z": r.rand((n, self.nz)) * 2.0 - 1.0}

    def generator(self, p: Params, state: Params, draws: Dict):
        x = F.linear(draws["z"], p["linear.weight"], p["linear.bias"])
        x = F.relu(batch_norm(x, p, state, "norm_init"))
        s = self.size // 8
        x = x.reshape(-1, 8 * self.ngf, s, s)
        for i in range(3):
            x = F.conv_transpose2d(x, p[f"up{i}.weight"], p[f"up{i}.bias"],
                                   stride=2, padding=1)
            x = F.relu(batch_norm(x, p, state, f"norm{i}"))
        x = F.conv2d(x, p["to_rgb.weight"], p["to_rgb.bias"], padding=1)
        return (0.5 * torch.tanh(x) + 0.5).permute(0, 2, 3, 1)

    def discriminator(self, p: Params, state: Params, x, staged=None,
                      sg_linear: bool = False):
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        for i, (_, _, _, stride) in enumerate(self.d_layers):
            key = f"backbone.c{i}"
            w = sn_weight(p[key + ".weight"], state[key + ".u"], staged,
                          key + ".u")
            x = F.leaky_relu(F.conv2d(x, w, p[key + ".bias"], stride, 1), 0.1)
        feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return heads(feats, p, state, staged, sg_linear)


MODEL = SNDCGAN
