"""upfirdn2d: zero-insert upsample, pad, FIR filter, downsample (the port of
``contrad_tpu/ops/upfirdn2d.py``).

``upfirdn2d`` is one XLA depthwise conv in the JAX package, so here it is
plain PyTorch depthwise convolutions. ``blur2d`` (the ``up = down = 1`` case)
routes to the hand-written kernel in :mod:`contrad_tpu_torch.ops.blur`, the
port of the Pallas kernel ``contrad_tpu/ops/pallas_blur.py::pallas_blur2d``.
Layout NHWC; the FIR kernel is correlated as given (the StyleGAN2 kernels are
symmetric).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contrad_tpu_torch.ops import blur as _blur
from contrad_tpu_torch.ops import device_constant


def make_kernel(k: Sequence[float]) -> np.ndarray:
    """1-D -> outer product; normalised to sum 1 (reference layers.py:23-31)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def _is_separable(kernel: np.ndarray) -> bool:
    if kernel.ndim != 2:
        return False
    s = np.linalg.svd(kernel, compute_uv=False)
    return bool(s[1:].max(initial=0.0) < 1e-6 * max(s[0], 1e-30))


def separate(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The rank-1 factors (column, row) of a separable kernel, as the JAX
    package takes them (SVD, positive orientation)."""
    u, s, vt = np.linalg.svd(np.asarray(kernel))
    col = u[:, 0] * np.sqrt(s[0])
    row = vt[0] * np.sqrt(s[0])
    if col.sum() < 0:
        col, row = -col, -row
    return col.astype(np.float32), row.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _filters(kernel: Tuple[Tuple[float, ...], ...], down: int):
    """The depthwise passes of a (kh, kw) kernel, found once per kernel and
    ``down``: its column and row factors where it is separable, else the
    kernel itself; each as (taps, filter shape, stride)."""
    k = np.asarray(kernel, np.float32)
    if _is_separable(k):
        col, row = separate(k)
        return ((tuple(col.tolist()), (len(col), 1), (down, 1)),
                (tuple(row.tolist()), (1, len(row)), (1, down)))
    return ((tuple(k.ravel().tolist()), k.shape, (down, down)),)


def _depthwise(x: torch.Tensor, taps: Tuple[float, ...],
               shape: Tuple[int, int], stride: Tuple[int, int]):
    """Depthwise correlation of an NCHW tensor with one (kh, kw) filter."""
    wt = device_constant(taps, x.dtype, x.device).view(shape)
    wt = wt[None, None].expand(x.shape[1], 1, *shape)
    return F.conv2d(x, wt, stride=stride, groups=x.shape[1])


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x: (N, H, W, C); kernel: (kh, kw) numpy FIR filter; ``pad`` applies to
    both spatial dims (negative crops). Output size per dim:
    ``(size * up + pad0 + pad1 - k) // down + 1``."""
    n, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    if up > 1:
        # zero insertion, trailing zeros included (in * up samples)
        z = xc.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = xc
        xc = z.reshape(n, c, h * up, w * up)
    xc = F.pad(xc, (pad[0], pad[1], pad[0], pad[1]))
    key = tuple(map(tuple, np.asarray(kernel, np.float32).tolist()))
    for taps, shape, stride in _filters(key, down):
        xc = _depthwise(xc, taps, shape, stride)
    return xc.permute(0, 2, 3, 1)


def upsample2d(x: torch.Tensor, kernel: np.ndarray, factor: int = 2):
    k = kernel * (factor**2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel: np.ndarray, factor: int = 2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))


def compose_blur_kernel(blur: np.ndarray, w: torch.Tensor) -> torch.Tensor:
    """Fold a FIR blur into an adjacent conv: K[o, i, u, v] =
    sum_{s,t} blur[s, t] * w[o, i, u - s, v - t], the full 2-D convolution
    over the spatial dims (``contrad_tpu/ops/upfirdn2d.py:105``).

    conv_s(blur(x), w) == conv_s(x, K) and blur(conv_transpose(x, w)) ==
    lhs-dilated-conv(x, K) with adjusted padding, exactly, the blur being a
    per-channel spatial filter. The models keep the blur kernel, then the
    conv; this serves the comparison of the two (``chip_smoke.py`` phase
    14) and the tests.

    ``blur``: (kb, kb) numpy; ``w``: OIHW (out, in, k, k). Returns
    (out, in, k+kb-1, k+kb-1), as one matmul against the JAX package's
    static (kk^2, k^2) tap matrix."""
    kb = blur.shape[0]
    out_ch, in_ch, k, _ = w.shape
    kk = k + kb - 1
    m = np.zeros((kk * kk, k * k), np.float32)
    for u in range(kk):
        for v in range(kk):
            for d in range(max(0, u - kb + 1), min(k, u + 1)):
                for e in range(max(0, v - kb + 1), min(k, v + 1)):
                    m[u * kk + v, d * k + e] = blur[u - d, v - e]
    mt = device_constant(tuple(m.ravel().tolist()), w.dtype,
                         w.device).view(kk * kk, k * k)
    out = w.reshape(out_ch * in_ch, k * k) @ mt.T
    return out.reshape(out_ch, in_ch, kk, kk)


def blur_taps(kernel: np.ndarray, upsample_factor: int = 1):
    """(vertical, horizontal) taps of ``kernel * upsample_factor**2``."""
    k = kernel * (upsample_factor**2) if upsample_factor > 1 else kernel
    col, row = separate(k)
    return tuple(float(v) for v in col), tuple(float(v) for v in row)


def blur2d(x: torch.Tensor, kernel: np.ndarray, pad: Tuple[int, int],
           upsample_factor: int = 1) -> torch.Tensor:
    """The ``up = down = 1`` FIR blur of an NHWC tensor, through the blur
    kernel (CUDA tensors) or its plain version (CPU tensors)."""
    taps_v, taps_h = blur_taps(kernel, upsample_factor)
    return _blur.blur2d(x, taps_v, taps_h, pad)
