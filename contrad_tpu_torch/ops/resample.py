"""Per-sample axis-aligned affine warp (the port of
``contrad_tpu/ops/resample.py::axis_aligned_transform``, bilinear sampling
with reflection padding, the case the simclr chain uses).

Every spatial augment of the slice is an axis-aligned affine, so the
bilinear warp factorises per axis into two batched matrix products,
``out[n,i,j,c] = sum_h Wy[n,i,h] * sum_w Wx[n,j,w] * x[n,h,w,c]``, with at
most two non-zeros per row of ``Wy`` and ``Wx``. Conventions are torch's
``grid_sample(align_corners=False)``: reflection about -0.5 and S-0.5.
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


def _axis_weight_matrix(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """coords (N, S_out) source pixel positions -> (N, S_out, S_in) bilinear
    weights under reflection padding."""
    coords = _reflect_coords(coords, in_size)
    cols = torch.arange(in_size, device=coords.device)
    x0f = torch.floor(coords)
    t = coords - x0f
    i0 = torch.clamp(x0f.long(), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, 0, in_size - 1)
    w0 = (cols == i0[..., None]).float() * (1.0 - t)[..., None]
    w1 = (cols == i1[..., None]).float() * t[..., None]
    return w0 + w1


def axis_aligned_transform(images: torch.Tensor, scale_x: torch.Tensor,
                           scale_y: torch.Tensor, bias_x: torch.Tensor,
                           bias_y: torch.Tensor) -> torch.Tensor:
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
    wx = _axis_weight_matrix(ix, w).to(images.dtype)  # (N, W, W_in)
    wy = _axis_weight_matrix(iy, h).to(images.dtype)  # (N, H, H_in)
    out = torch.einsum("nih,nhwc->niwc", wy, images)
    return torch.einsum("njw,niwc->nijc", wx, out)
