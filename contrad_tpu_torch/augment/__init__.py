"""Augmentation registry and compositions (the port of
``contrad_tpu/augment/__init__.py``, every mode of its registry: ``none``,
``gaussian``, ``hflip``, ``hfrt``, ``color_jitter``, ``cutout``, ``simclr``,
``simclr_hq``, ``simclr_hq_cutout`` and ``diffaug``).

An augmentation has ``sample(shape, rng) -> params`` and
``apply(x, params) -> images`` (NHWC float in [0, 1]).
``rng`` is an :class:`AugRng`: a generator on the images' device, for every
draw (per-sample parameters and per-batch choices alike, so that no draw
steers Python control flow and a step can be captured in a CUDA graph).

  simclr            = RRC -> HFlip -> RandomApply(Jitter, .8) -> RandomApply(Gray, .2)
  simclr_hq         = simclr + RandomApply(Blur, .5)
  simclr_hq_cutout  = simclr_hq + RandomApply(CutOut, .5)

A trainer applies its augments through :func:`traced`, so that each
outermost application is one ``aug`` phase of the train step
(``utils/trace.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional

import torch

from contrad_tpu_torch.augment.color import (
    ColorJitter, GaussianBlur, GaussianNoise, Grayscale)
from contrad_tpu_torch.augment.diffaug import DiffAugment
from contrad_tpu_torch.augment.spatial import (
    CutOut, HFlipRandomCrop, HorizontalFlip, Params, RandomCrop,
    RandomResizeCrop, _uniform)
from contrad_tpu_torch.utils.trace import phase


@dataclasses.dataclass
class AugRng:
    device: torch.Generator  # every draw, on the images' device

    @classmethod
    def from_seed(cls, seed: int, device: torch.device) -> "AugRng":
        dev = torch.Generator(device=device)
        dev.manual_seed(seed)
        return cls(dev)


class NoAugment:
    def sample(self, shape, rng):
        return None

    def apply(self, x, params):
        return x


class RandomApply:
    """Per-sample Bernoulli blend ``x * (1 - m) + fn(x) * m`` (reference
    RandomApply, augment/__init__.py:94-103)."""

    def __init__(self, fn, p: float):
        self.fn, self.p = fn, p

    def sample(self, shape, rng) -> Params:
        return {"mask": _uniform((shape[0],), rng) < self.p,
                "inner": self.fn.sample(shape, rng)}

    def apply(self, x, params):
        m = params["mask"].to(x.dtype)[:, None, None, None]
        return x * (1.0 - m) + self.fn.apply(x, params["inner"]) * m


class Compose:
    def __init__(self, *stages):
        self.stages = stages

    def sample(self, shape, rng) -> List[Any]:
        # every stage keeps the batch's shape
        return [s.sample(shape, rng) for s in self.stages]

    def apply(self, x, params):
        for stage, p in zip(self.stages, params):
            x = stage.apply(x, p)
        return x


class Traced:
    """``inner`` with each ``apply`` one ``aug`` phase; the stages inside it
    (``Compose`` -> ``RandomApply`` -> ...) add no marks."""

    def __init__(self, inner):
        self.inner = inner

    def sample(self, shape, rng):
        return self.inner.sample(shape, rng)

    def apply(self, x, params):
        with phase("aug", x.device):
            return self.inner.apply(x, params)


def traced(augment):
    """``augment`` as a :class:`Traced` (None stays None)."""
    return None if augment is None else Traced(augment)


# Default hyperparameters: reference configs/defaults/augment.gin.
_DEFAULTS = {
    "gaussian": {"sigma": 0.12},
    "random_crop": {"max_pixels": 4, "padding_mode": "reflection"},
    "hfrt": {"max_pixels": 4, "padding_mode": "reflection"},
    "color_jitter": {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                     "hue": 0.1},
    "cutout": {"length": 15},
    "rrc": {"scale": (0.2, 1.0), "ratio": (0.75, 4.0 / 3.0)},
    "blur": {"sigma_range": (0.1, 2.0)},
    "diffaug": {"policy": "color,cutout"},
}


def _hyper(params: Optional[Mapping], key: str) -> dict:
    out = dict(_DEFAULTS.get(key, {}))
    if params and key in params:
        out.update({k: tuple(v) if isinstance(v, list) else v
                    for k, v in dict(params[key]).items()})
    return out


def get_augment(mode: str = "none", params: Optional[Mapping] = None):
    """Build an augmentation pipeline; ``params`` is the config's [augment]
    table."""
    if mode == "none":
        return NoAugment()
    if mode == "gaussian":
        return GaussianNoise(**_hyper(params, "gaussian"))
    if mode == "hflip":
        return HorizontalFlip()
    if mode == "hfrt":
        return HFlipRandomCrop(**_hyper(params, "hfrt"))
    if mode == "color_jitter":
        return ColorJitter(**_hyper(params, "color_jitter"))
    if mode == "cutout":
        return CutOut(**_hyper(params, "cutout"))
    if mode == "diffaug":
        return DiffAugment(**_hyper(params, "diffaug"))
    if mode in ("simclr", "simclr_hq", "simclr_hq_cutout"):
        stages = [
            RandomResizeCrop(**_hyper(params, "rrc")),
            HorizontalFlip(),
            RandomApply(ColorJitter(**_hyper(params, "color_jitter")), 0.8),
            RandomApply(Grayscale(), 0.2),
        ]
        if mode != "simclr":
            stages.append(RandomApply(GaussianBlur(**_hyper(params, "blur")),
                                      0.5))
        if mode == "simclr_hq_cutout":
            stages.append(RandomApply(CutOut(**_hyper(params, "cutout")), 0.5))
        return Compose(*stages)
    raise NotImplementedError(f"unknown augmentation mode: {mode}")


__all__ = ["AugRng", "Compose", "RandomApply", "NoAugment", "get_augment",
           "traced",
           "ColorJitter", "CutOut", "DiffAugment", "GaussianBlur",
           "GaussianNoise", "Grayscale", "HFlipRandomCrop", "HorizontalFlip",
           "RandomCrop", "RandomResizeCrop"]
