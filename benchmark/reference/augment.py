"""The SimCLR augmentations of ContraD, in plain PyTorch (ContraD's
``augment/__init__.py``, ``color_jitter.py`` and ``augment/utils.py``):

    simclr    = RandomResizedCrop -> HFlip -> RandomApply(ColorJitter, .8)
                -> RandomApply(Grayscale, .2)
    simclr_hq = simclr + RandomApply(GaussianBlur, .5)

Images are NHWC floats in [0, 1]. ``sample`` draws a batch's parameters in
the order the step under test draws them; ``apply`` is a function of the
images and those parameters. The crop is ``F.affine_grid`` and
``F.grid_sample`` (bilinear, reflection padding, ``align_corners=False``);
the colour jitter's HSV adjustment passes its gradient straight through, as
ContraD's ``RandomHSVFunction`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.draws import Rand
from benchmark.reference.nets import per_channel

GRAY = (0.299, 0.587, 0.114)


def jitter_range(value: float, center: float = 1.0,
                 clip_zero: bool = True) -> Tuple[float, float]:
    lo, hi = center - value, center + value
    return (max(lo, 0.0) if clip_zero else lo), hi


class SimCLR:
    """``hp``: the recipe's ``rrc`` scale, ``color_jitter`` strengths and
    ``blur`` sigma range; ``hq`` adds the Gaussian blur."""

    def __init__(self, hp: Dict, hq: bool):
        self.scale = tuple(hp["rrc"]["scale"])
        self.log_ratio = (math.log(3.0 / 4.0), math.log(4.0 / 3.0))
        cj = hp["color_jitter"]
        self.b = jitter_range(cj["brightness"])
        self.c = jitter_range(cj["contrast"])
        self.s = jitter_range(cj["saturation"])
        self.h = jitter_range(cj["hue"], center=0.0, clip_zero=False)
        self.hq = hq
        self.sigma = tuple(hp["blur"]["sigma_range"])

    # ----------------------------------------------------------- draws

    def sample(self, shape, r: Rand) -> Dict[str, torch.Tensor]:
        n, h, w = shape[0], shape[1], shape[2]
        p = {}
        area = r.uniform((n, 10), *self.scale) * float(h * w)
        aspect = torch.exp(r.uniform((n, 10), *self.log_ratio))
        p.update(self._crop(area, aspect, r.rand((n,)), r.rand((n,)), h, w))
        p["flip"] = r.rand((n,)) < 0.5
        p["jitter"] = r.rand((n,)) < 0.8
        p["contrast_first"] = r.rand(()) < 0.5
        p["f_c"] = r.uniform((n,), *self.c)
        p["f_h"] = r.uniform((n,), *self.h)
        p["f_s"] = r.uniform((n,), *self.s)
        p["f_v"] = r.uniform((n,), *self.b)
        p["gray"] = r.rand((n,)) < 0.2
        if self.hq:
            p["blur"] = r.rand((n,)) < 0.5
            p["sigma"] = r.uniform((), *self.sigma)
        return p

    @staticmethod
    def _crop(area, aspect, u_w, u_h, h, w):
        """The first of the 10 candidates that fits, else the whole image;
        an integer offset in ``[size - W, W - size]`` pixels."""
        cw = torch.round(torch.sqrt(area * aspect))
        ch = torch.round(torch.sqrt(area / aspect))
        fits = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
        first = torch.argmax(fits.int(), dim=1, keepdim=True)
        found = fits.any(dim=1)
        cw = torch.gather(cw, 1, first)[:, 0]
        ch = torch.gather(ch, 1, first)[:, 0]
        bx = (torch.floor(u_w * (2.0 * (w - cw) + 1.0)) - (w - cw)) / w
        by = (torch.floor(u_h * (2.0 * (h - ch) + 1.0)) - (h - ch)) / h
        one, zero = torch.ones_like(cw), torch.zeros_like(cw)
        return {"sx": torch.where(found, cw / w, one),
                "sy": torch.where(found, ch / h, one),
                "bx": torch.where(found, bx, zero),
                "by": torch.where(found, by, zero)}

    # ----------------------------------------------------------- apply

    def apply(self, x: torch.Tensor, p) -> torch.Tensor:
        n = x.shape[0]
        theta = torch.zeros(n, 2, 3, device=x.device, dtype=x.dtype)
        theta[:, 0, 0], theta[:, 0, 2] = p["sx"], p["bx"]
        theta[:, 1, 1], theta[:, 1, 2] = p["sy"], p["by"]
        xc = x.permute(0, 3, 1, 2)
        grid = F.affine_grid(theta, list(xc.shape), align_corners=False)
        x = F.grid_sample(xc, grid, mode="bilinear", padding_mode="reflection",
                          align_corners=False).permute(0, 2, 3, 1)
        x = torch.where(p["flip"][:, None, None, None], x.flip(2), x)
        x = blend(x, self._jitter(x, p), p["jitter"])
        gray = (x * x.new_tensor(GRAY)).sum(-1, keepdim=True).expand(x.shape)
        x = blend(x, gray, p["gray"])
        if self.hq:
            x = blend(x, gaussian_blur(x, p["sigma"]), p["blur"])
        return x

    def _jitter(self, x, p):
        def contrast(y):
            f = p["f_c"][:, None, None, None]
            m = y.mean(dim=(1, 2), keepdim=True)
            return torch.clamp((y - m) * f + m, 0.0, 1.0)

        def hsv(y):  # straight-through gradient
            out = hsv_adjust(y.detach(), p["f_h"], p["f_s"], p["f_v"])
            return y + (out - y).detach()

        return torch.where(p["contrast_first"], hsv(contrast(x)),
                           contrast(hsv(x)))


def blend(x, y, mask):
    m = mask.to(x.dtype)[:, None, None, None]
    return x * (1.0 - m) + y * m


def hsv_adjust(x, f_h, f_s, f_v):
    """Hue shift by ``f_h * 255 / 360`` of a turn, saturation and value
    scaled, in ContraD's HSV (hue from ``atan2``)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    cmax, cmin = x.amax(-1), x.amin(-1)
    hue = torch.atan2(math.sqrt(3.0) * (g - b), 2.0 * r - g - b)
    hue = torch.remainder(hue, 2.0 * math.pi) / (2.0 * math.pi)
    sat = 1.0 - cmin / (cmax + 1e-8)
    hsv = torch.stack([hue, sat, cmax], -1)
    hsv = torch.where(torch.isfinite(hsv), hsv, torch.zeros_like(hsv))
    h = torch.remainder(hsv[..., 0] + f_h[:, None, None] * (255.0 / 360.0),
                        1.0)
    s = hsv[..., 1] * f_s[:, None, None]
    v = hsv[..., 2] * f_v[:, None, None]
    hsv = torch.clamp(torch.stack([h, s, v], -1), 0.0, 1.0)
    h, s, v = hsv[..., 0:1], hsv[..., 1:2], hsv[..., 2:3]
    k = torch.remainder(x.new_tensor((5.0, 3.0, 1.0)) + h * 6.0, 6.0)
    return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)


def gaussian_blur(x, sigma):
    """Separable Gaussian of ``(H // 10) | 1`` taps, one ``sigma`` for the
    batch, reflect padding that does not repeat the edge."""
    h = x.shape[1]
    r = (h // 10) // 2
    t = torch.arange(-r, r + 1, device=x.device, dtype=x.dtype)
    k = torch.exp(-t**2 / (2.0 * sigma**2))
    k = k / k.sum()
    y = F.pad(x.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect")
    y = per_channel(per_channel(y, k.view(-1, 1)), k.view(1, -1))
    return y.permute(0, 2, 3, 1)


def hflip_sample(n: int, r: Rand) -> torch.Tensor:
    """The data's random mirror (``_hflip`` sets and AFHQ)."""
    return r.rand((n,)) < 0.5


def hflip_apply(x, flip):
    return torch.where(flip[:, None, None, None], x.flip(2), x)
