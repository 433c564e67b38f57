"""Spatial augmentations (the port of ``contrad_tpu/augment/spatial.py``:
``horizontal_flip``, ``hflip_random_crop``, ``random_crop``,
``random_resize_crop`` and ``cutout``).

Each augmentation is split in two: ``sample(shape, rng)`` draws the
per-sample parameters for an NHWC batch of that shape from ``rng.device``
(a ``torch.Generator`` on the batch's device), and ``apply(x, params)`` is
a pure function of the batch and those parameters, so the tests can apply
the parameters JAX drew.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from contrad_tpu_torch.ops.resample import axis_aligned_transform

Params = Dict[str, torch.Tensor]


def _uniform(shape, rng, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=rng.device, device=rng.device.device)
    return u * (hi - lo) + lo


def _randint(shape, rng, lo: int, hi: int) -> torch.Tensor:
    """Integers in ``[lo, hi)``, as ``jax.random.randint`` draws them."""
    return torch.randint(lo, hi, shape, generator=rng.device,
                         device=rng.device.device)


class HorizontalFlip:
    """Per-sample 50% mirror (reference HorizontalFlipLayer, spatial.py:71-93)."""

    def sample(self, shape, rng) -> Params:
        return {"flip": _uniform((shape[0],), rng) < 0.5}

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        return torch.where(params["flip"][:, None, None, None], x.flip(2), x)


class RandomCrop:
    """Integer translation of up to ``max_pixels``, nearest sampling
    (reference RandomCrop, spatial.py:44-67). The translation is divided by
    ``W / 2`` on both axes, as the JAX package does."""

    def __init__(self, max_pixels: int, padding_mode: str = "reflection"):
        self.max_pixels = max_pixels
        self.padding_mode = padding_mode

    def sample(self, shape, rng) -> Params:
        """``bias`` (N, 2): integer pixels in ``[-max_pixels, max_pixels]``."""
        return {"bias": _randint((shape[0], 2), rng, -self.max_pixels,
                                 self.max_pixels + 1)}

    def _warp(self, x: torch.Tensor, sign: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
        bias = bias.float() / (x.shape[2] / 2.0)
        return axis_aligned_transform(
            x, sign, torch.ones_like(sign), bias[:, 0], bias[:, 1],
            mode="nearest", padding_mode=self.padding_mode)

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        ones = torch.ones(x.shape[0], device=x.device)
        return self._warp(x, ones, params["bias"])


class HFlipRandomCrop(RandomCrop):
    """Random mirror and an integer translation (reference
    HorizontalFlipRandomCrop, spatial.py:15-40)."""

    def sample(self, shape, rng) -> Params:
        """``flip`` (N,) bool, then ``bias`` as :class:`RandomCrop`."""
        flip = _uniform((shape[0],), rng) < 0.5
        return dict(super().sample(shape, rng), flip=flip)

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        sign = params["flip"].float() * 2.0 - 1.0
        return self._warp(x, sign, params["bias"])


class CutOut:
    """Zero a ``length`` x ``length`` square at a random centre, clipped at
    the borders (reference CutOut, spatial.py:152-181)."""

    def __init__(self, length: int):
        if length % 2 == 0:
            raise ValueError("CutOut only accepts odd lengths (reference "
                             "spatial.py:156)")
        self.radius = (length - 1) // 2

    def sample(self, shape, rng) -> Params:
        """Centres ``hc`` in ``[0, H)`` and ``wc`` in ``[0, W)``, (N,) each."""
        n, h, w = shape[0], shape[1], shape[2]
        return {"hc": _randint((n,), rng, 0, h), "wc": _randint((n,), rng, 0, w)}

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        ii = torch.arange(h, device=x.device)
        jj = torch.arange(w, device=x.device)
        in_h = (ii[None, :] - params["hc"][:, None]).abs() <= self.radius
        in_w = (jj[None, :] - params["wc"][:, None]).abs() <= self.radius
        cut = in_h[:, :, None] & in_w[:, None, :]  # (N, H, W)
        return x * (1.0 - cut.to(x.dtype))[..., None]


def crop_params(target_area: torch.Tensor, aspect: torch.Tensor,
                u_w: torch.Tensor, u_h: torch.Tensor, h: int, w: int) -> Params:
    """First valid of the (area, aspect) candidates per sample (identity if
    none), and an integer translation in ``[size - W, W - size]``
    (reference spatial.py:97-148)."""
    ww = torch.round(torch.sqrt(target_area * aspect))
    hh = torch.round(torch.sqrt(target_area / aspect))
    valid = (ww > 0) & (ww <= w) & (hh > 0) & (hh <= h)
    first = torch.argmax(valid.int(), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    ww_s = torch.gather(ww, 1, first)[:, 0]
    hh_s = torch.gather(hh, 1, first)[:, 0]
    span_w = w - ww_s
    span_h = h - hh_s
    bias_w = (torch.floor(u_w * (2.0 * span_w + 1.0)) - span_w) / w
    bias_h = (torch.floor(u_h * (2.0 * span_h + 1.0)) - span_h) / h
    one, zero = torch.ones_like(ww_s), torch.zeros_like(ww_s)
    return {"sx": torch.where(any_valid, ww_s / w, one),
            "sy": torch.where(any_valid, hh_s / h, one),
            "bx": torch.where(any_valid, bias_w, zero),
            "by": torch.where(any_valid, bias_h, zero)}


class RandomResizeCrop:
    """Inception-style random resized crop: ``n_trials`` candidates per
    sample, the first valid one taken (reference RandomResizeCropLayer)."""

    def __init__(self, scale: Tuple[float, float] = (0.2, 1.0),
                 ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                 n_trials: int = 10):
        self.scale = tuple(scale)
        self.log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        self.n_trials = n_trials

    def sample(self, shape, rng) -> Params:
        n, h, w = shape[0], shape[1], shape[2]
        area = float(h * w)
        target_area = _uniform((n, self.n_trials), rng, *self.scale) * area
        aspect = torch.exp(_uniform((n, self.n_trials), rng, *self.log_ratio))
        return crop_params(target_area, aspect, _uniform((n,), rng),
                           _uniform((n,), rng), h, w)

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        return axis_aligned_transform(x, params["sx"], params["sy"],
                                      params["bx"], params["by"])
