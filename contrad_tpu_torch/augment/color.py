"""Colour augmentations (the port of ``contrad_tpu/augment/color.py``:
``color_jitter``, ``grayscale``, the HSV conversions, ``gaussian_noise`` and
``gaussian_blur``).

The HSV adjustment keeps the reference's straight-through gradient
(RandomHSVFunction, ``color_jitter.py:81-104``): its backward passes the
incoming gradient through unchanged.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from contrad_tpu_torch.augment.spatial import Params, _uniform
from contrad_tpu_torch.ops import device_constant

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def rgb2hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Branchless RGB->HSV with atan2 hue (reference augment/utils.py:6-38)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    cmax = rgb.amax(dim=-1)
    cmin = rgb.amin(dim=-1)
    hue = torch.atan2(math.sqrt(3.0) * (g - b), 2.0 * r - g - b)
    hue = torch.remainder(hue, 2.0 * math.pi) / (2.0 * math.pi)
    saturate = 1.0 - cmin / (cmax + 1e-8)
    hsv = torch.stack([hue, saturate, cmax], dim=-1)
    return torch.where(torch.isfinite(hsv), hsv, torch.zeros_like(hsv))


def hsv2rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Branchless HSV->RGB (reference augment/utils.py:41-62)."""
    h, s, v = hsv[..., 0:1], hsv[..., 1:2], hsv[..., 2:3]
    c = v * s
    n = device_constant((5.0, 3.0, 1.0), hsv.dtype, hsv.device)
    k = torch.remainder(n + h * 6.0, 6.0)
    t = torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)
    return v - c * t


class _HSVAdjust(torch.autograd.Function):
    """Hue shift, saturation and value scaling in HSV space; the gradient
    passes straight through to ``x``."""

    @staticmethod
    def forward(ctx, x, f_h, f_s, f_v):
        hsv = rgb2hsv(x)
        h = torch.remainder(hsv[..., 0] + f_h * (255.0 / 360.0), 1.0)
        s = hsv[..., 1] * f_s
        v = hsv[..., 2] * f_v
        return hsv2rgb(torch.clamp(torch.stack([h, s, v], dim=-1), 0.0, 1.0))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def _check_range(value, name, center=1.0, bound=(0.0, float("inf")),
                 clip_first_on_zero=True) -> Optional[Tuple[float, float]]:
    """torchvision-style jitter range handling (color_jitter.py:25-42)."""
    if isinstance(value, (int, float)):
        if value < 0:
            raise ValueError(f"If {name} is a single number, it must be non negative.")
        lo, hi = center - value, center + value
        if clip_first_on_zero:
            lo = max(lo, 0.0)
    elif isinstance(value, Sequence) and len(value) == 2:
        lo, hi = float(value[0]), float(value[1])
        if not bound[0] <= lo <= hi <= bound[1]:
            raise ValueError(f"{name} values should be between {bound}")
    else:
        raise TypeError(f"{name} should be a number or a pair.")
    if lo == hi == center:
        return None
    return (lo, hi)


class ColorJitter:
    """Per-sample brightness/contrast/saturation/hue jitter (reference
    ColorJitterLayer): contrast in RGB space, B/S/H jointly in HSV space, the
    two applied in an order drawn once per batch. The order is a device
    bool drawn from ``rng.device`` (JAX draws it on the device and picks
    with ``lax.cond``): ``apply`` computes both orders and selects one with
    ``torch.where``, so no host branch reads it and a step captured in a
    CUDA graph draws it anew at each replay."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1):
        self.b_range = _check_range(brightness, "brightness")
        self.c_range = _check_range(contrast, "contrast")
        self.s_range = _check_range(saturation, "saturation")
        self.h_range = _check_range(hue, "hue", center=0.0, bound=(-0.5, 0.5),
                                    clip_first_on_zero=False)

    def sample(self, shape, rng) -> Params:
        n = shape[0]

        def draw(rng_range, default):
            if rng_range is None:
                return torch.full((n,), default, device=rng.device.device)
            return _uniform((n,), rng, *rng_range)

        return {
            "contrast_first": _uniform((), rng) < 0.5,
            "contrast": draw(self.c_range, 1.0),
            "f_h": draw(self.h_range, 0.0),
            "f_s": draw(self.s_range, 1.0),
            "f_v": draw(self.b_range, 1.0),
        }

    def _contrast(self, x, params):
        if self.c_range is None:
            return torch.clamp(x, 0.0, 1.0)
        factor = params["contrast"].to(x.dtype)[:, None, None, None]
        means = x.mean(dim=(1, 2), keepdim=True)
        return torch.clamp((x - means) * factor + means, 0.0, 1.0)

    def _hsv(self, x, params):
        f = [params[k].to(x.dtype)[:, None, None] for k in ("f_h", "f_s", "f_v")]
        return _HSVAdjust.apply(x, *f)

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        return torch.where(params["contrast_first"],
                           self._hsv(self._contrast(x, params), params),
                           self._contrast(self._hsv(x, params), params))


class Grayscale:
    """Luminance-weighted grayscale (reference RandomColorGrayLayer)."""

    def sample(self, shape, rng) -> Params:
        return {}

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        w = device_constant(_GRAY_WEIGHTS, x.dtype, x.device)
        return (x * w).sum(dim=-1, keepdim=True).expand(x.shape)


class GaussianNoise:
    """Additive Gaussian noise of std ``sigma``, clamped to [0, 1]
    (reference Gaussian layer)."""

    def __init__(self, sigma: float = 0.12):
        self.sigma = sigma

    def sample(self, shape, rng) -> Params:
        """``noise``: N(0, 1), the batch's shape."""
        return {"noise": torch.randn(tuple(shape), generator=rng.device,
                                     device=rng.device.device)}

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        return torch.clamp(x + params["noise"].to(x.dtype) * self.sigma,
                           0.0, 1.0)


@functools.lru_cache(maxsize=16)
def _reflect_columns(dim: int, radius: int, device: torch.device
                     ) -> torch.Tensor:
    """(dim, 2 * radius + 1) source column of each tap of each output row
    under reflect padding without repeating the edge (``jnp.pad``'s
    ``reflect``); made once per size and device."""
    cols = torch.arange(dim)[:, None] + torch.arange(-radius, radius + 1)
    cols = cols.abs()
    cols = torch.where(cols >= dim, 2 * dim - 2 - cols, cols)
    return cols.to(device)


class GaussianBlur:
    """Gaussian blur with ``ksize = (H // 10) | 1`` taps and one sigma per
    batch, reflect padding (reference GaussianBlur layer,
    augment/__init__.py:53-78).

    As in the JAX package, the separable filter is two banded-Toeplitz
    products ``T_h @ X @ T_w^T`` with the padding folded into ``T``; ``T``
    is built on the images' device from the drawn sigma."""

    def __init__(self, sigma_range: Tuple[float, float] = (0.1, 2.0)):
        self.sigma_range = tuple(sigma_range)

    def sample(self, shape, rng) -> Params:
        """``sigma``: one scalar in ``sigma_range`` for the batch."""
        return {"sigma": _uniform((), rng, *self.sigma_range)}

    @staticmethod
    def toeplitz(sigma: torch.Tensor, dim: int, radius: int) -> torch.Tensor:
        """(dim, dim) float32 ``T`` with ``T[i, reflect(i - r + k)] +=
        kern[k]``."""
        coords = torch.arange(-radius, radius + 1, dtype=torch.float32,
                              device=sigma.device)
        kern = torch.exp(-coords**2 / (2.0 * sigma.float()**2))
        kern = kern / kern.sum()
        cols = _reflect_columns(dim, radius, sigma.device)
        t = torch.zeros(dim, dim, dtype=torch.float32, device=sigma.device)
        return t.scatter_add_(1, cols, kern.expand(dim, -1).contiguous())

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        radius = (h // 10) // 2
        th = self.toeplitz(params["sigma"], h, radius).to(x.dtype)
        tw = th if w == h else self.toeplitz(params["sigma"], w,
                                             radius).to(x.dtype)
        y = torch.einsum("Hh,nhwc->nHwc", th, x)
        return torch.einsum("Ww,nhwc->nhWc", tw, y)


__all__ = ["ColorJitter", "Grayscale", "GaussianNoise", "GaussianBlur",
           "rgb2hsv", "hsv2rgb"]
