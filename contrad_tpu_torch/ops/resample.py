"""Per-sample axis-aligned affine warp (the port of
``contrad_tpu/ops/resample.py::axis_aligned_transform``): bilinear or
nearest sampling, with ``zeros``, ``border`` or ``reflection`` padding.

Every spatial augment of the port is an axis-aligned affine, so the warp
factorises per axis into two batched matrix products,
``out[n,i,j,c] = sum_h Wy[n,i,h] * sum_w Wx[n,j,w] * x[n,h,w,c]``, with at
most two non-zeros per row of ``Wy`` and ``Wx``. Conventions are torch's
``grid_sample(align_corners=False)``: normalised output coordinates
``(2j + 1) / W - 1``; reflection about -0.5 and S-0.5; ``zeros`` drops what
falls outside; nearest rounds half to even, as ``jnp.round`` and
``torch.round`` both do.
"""

from __future__ import annotations

import torch


def _reflect_coords(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect float pixel coords about -0.5 and size-0.5."""
    if size == 1:
        return torch.zeros_like(coords)
    span = 2.0 * size
    c = torch.remainder(coords + 0.5, span)
    c = torch.where(c >= size, span - c, c)
    return torch.clamp(c - 0.5, 0.0, size - 1.0)


def _one_hot(idx: torch.Tensor, in_size: int) -> torch.Tensor:
    cols = torch.arange(in_size, device=idx.device)
    return (cols == idx[..., None]).float()


def _axis_weight_matrix(coords: torch.Tensor, in_size: int, mode: str,
                        padding_mode: str) -> torch.Tensor:
    """coords (N, S_out) source pixel positions -> (N, S_out, S_in) sampling
    weights for one axis."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode: {mode}")
    if padding_mode == "zeros":
        if mode == "nearest":
            inside = (coords >= -0.5) & (coords <= in_size - 0.5)
            idx = torch.clamp(torch.round(coords).long(), 0, in_size - 1)
            return _one_hot(idx, in_size) * inside[..., None].float()
        x0 = torch.floor(coords)
        t = coords - x0
        w = 0.0
        for corner, weight in ((0, 1.0 - t), (1, t)):
            c = x0 + corner
            valid = (c >= 0) & (c <= in_size - 1)
            ci = torch.clamp(c.long(), 0, in_size - 1)
            w = w + _one_hot(ci, in_size) * (weight * valid.float())[..., None]
        return w

    if padding_mode == "border":
        coords = torch.clamp(coords, 0.0, in_size - 1.0)
    elif padding_mode == "reflection":
        coords = _reflect_coords(coords, in_size)
    else:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    if mode == "nearest":
        idx = torch.clamp(torch.round(coords).long(), 0, in_size - 1)
        return _one_hot(idx, in_size)
    x0f = torch.floor(coords)
    t = coords - x0f
    i0 = torch.clamp(x0f.long(), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, 0, in_size - 1)
    return (_one_hot(i0, in_size) * (1.0 - t)[..., None]
            + _one_hot(i1, in_size) * t[..., None])


def axis_aligned_transform(images: torch.Tensor, scale_x: torch.Tensor,
                           scale_y: torch.Tensor, bias_x: torch.Tensor,
                           bias_y: torch.Tensor, mode: str = "bilinear",
                           padding_mode: str = "reflection") -> torch.Tensor:
    """Warp an NHWC batch by per-sample ``theta = [[sx, 0, bx], [0, sy, by]]``
    (normalised coordinates); output has the input's size and dtype."""
    h, w = images.shape[1], images.shape[2]
    dev = images.device
    xs = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    src_x = scale_x[:, None] * xs[None, :] + bias_x[:, None]
    src_y = scale_y[:, None] * ys[None, :] + bias_y[:, None]
    ix = ((src_x + 1.0) * w - 1.0) / 2.0
    iy = ((src_y + 1.0) * h - 1.0) / 2.0
    wx = _axis_weight_matrix(ix, w, mode, padding_mode).to(images.dtype)
    wy = _axis_weight_matrix(iy, h, mode, padding_mode).to(images.dtype)
    out = torch.einsum("nih,nhwc->niwc", wy, images)
    return torch.einsum("njw,niwc->nijc", wx, out)
