"""DiffAugment policies (the port of ``contrad_tpu/augment/diffaug.py``;
reference ``third_party/diffaug.py``, Zhao et al. 2020).

NHWC, per-sample draws, fixed shapes. The chain runs on images rescaled to
[-1, 1] (reference ``diffaug.py:13-19``): brightness, saturation, contrast,
an integer translation with zero padding, and a cutout of fixed size whose
offsets range over the whole image and whose edges are clamped, so it
shrinks at the borders.
"""

from __future__ import annotations

from typing import Any, List

import torch

from contrad_tpu_torch.augment.spatial import Params, _randint, _uniform


class _Brightness:
    def sample(self, shape, rng) -> Params:
        return {"u": _uniform((shape[0],), rng)}

    def apply(self, x, p):
        return x + (p["u"].to(x.dtype) - 0.5)[:, None, None, None]


class _Saturation:
    def sample(self, shape, rng) -> Params:
        return {"u": _uniform((shape[0],), rng)}

    def apply(self, x, p):
        mean = x.mean(dim=-1, keepdim=True)
        return (x - mean) * (p["u"].to(x.dtype) * 2.0)[:, None, None, None] + mean


class _Contrast:
    def sample(self, shape, rng) -> Params:
        return {"u": _uniform((shape[0],), rng)}

    def apply(self, x, p):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        return (x - mean) * (p["u"].to(x.dtype) + 0.5)[:, None, None, None] + mean


class _Translation:
    """Per-sample shift by up to ``ratio`` of the size, zero padding
    (reference diffaug.py:41-54)."""

    ratio = 0.125

    def sample(self, shape, rng) -> Params:
        n, h, w = shape[0], shape[1], shape[2]
        sh, sw = int(h * self.ratio + 0.5), int(w * self.ratio + 0.5)
        return {"th": _randint((n,), rng, -sh, sh + 1),
                "tw": _randint((n,), rng, -sw, sw + 1)}

    def apply(self, x, p):
        n, h, w, _ = x.shape
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        ii = torch.clamp(torch.arange(h, device=x.device)[None, :]
                         + p["th"][:, None] + 1, 0, h + 1)  # (N, H)
        jj = torch.clamp(torch.arange(w, device=x.device)[None, :]
                         + p["tw"][:, None] + 1, 0, w + 1)  # (N, W)
        nn_ = torch.arange(n, device=x.device)[:, None, None]
        return xp[nn_, ii[:, :, None], jj[:, None, :]]


class _Cutout:
    """A zero rectangle of ``ratio`` of the size (reference
    diffaug.py:57-71)."""

    ratio = 0.5

    def sample(self, shape, rng) -> Params:
        n, h, w = shape[0], shape[1], shape[2]
        ch, cw = int(h * self.ratio + 0.5), int(w * self.ratio + 0.5)
        return {"off_h": _randint((n,), rng, 0, h + (1 - ch % 2)),
                "off_w": _randint((n,), rng, 0, w + (1 - cw % 2))}

    def apply(self, x, p):
        n, h, w, _ = x.shape
        ch, cw = int(h * self.ratio + 0.5), int(w * self.ratio + 0.5)
        lo_h = torch.clamp(p["off_h"] - ch // 2, 0, h - 1)[:, None]
        hi_h = torch.clamp(p["off_h"] - ch // 2 + ch - 1, 0, h - 1)[:, None]
        lo_w = torch.clamp(p["off_w"] - cw // 2, 0, w - 1)[:, None]
        hi_w = torch.clamp(p["off_w"] - cw // 2 + cw - 1, 0, w - 1)[:, None]
        ii = torch.arange(h, device=x.device)[None, :]
        jj = torch.arange(w, device=x.device)[None, :]
        in_h = (ii >= lo_h) & (ii <= hi_h)  # (N, H)
        in_w = (jj >= lo_w) & (jj <= hi_w)  # (N, W)
        cut = in_h[:, :, None] & in_w[:, None, :]
        return x * (1.0 - cut.to(x.dtype))[..., None]


_POLICIES = {
    "color": (_Brightness, _Saturation, _Contrast),
    "translation": (_Translation,),
    "cutout": (_Cutout,),
}


class DiffAugment:
    """The ``policy`` chain, e.g. ``"color,translation,cutout"``, on images
    in [0, 1]; ``sample`` gives one parameter set per op of the chain."""

    def __init__(self, policy: str = "color,cutout"):
        self.ops = [op() for name in policy.split(",") if name
                    for op in _POLICIES[name]]

    def sample(self, shape, rng) -> List[Any]:
        return [op.sample(shape, rng) for op in self.ops]

    def apply(self, x: torch.Tensor, params) -> torch.Tensor:
        if not self.ops:
            return x
        x = 2.0 * x - 1.0
        for op, p in zip(self.ops, params, strict=True):
            x = op.apply(x, p)
        return 0.5 * x + 0.5


__all__ = ["DiffAugment"]
