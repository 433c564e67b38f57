"""Space-to-depth packed convolutions (the port of
``contrad_tpu/ops/packed.py``), on NHWC tensors with the port's OIHW conv
weights.

The JAX package lays the 512x512 model's shallow levels (3, 32 and 64
channels) out as their space-to-depth packing for the TPU's 128 lanes: a
(B, H, W, C) activation becomes (B, H/f, W/f, f*f*C), and each conv kernel
is transformed so that the packed conv computes the same function
(:func:`pack_conv_kernel`). Parameters keep their shapes, so packing is
invisible to checkpoints, initialisation and the optimiser. On the H100 an
NHWC tensor of 32 channels is not padded, and a packed 3x3 conv does four
times the logical conv's multiply-adds; whether the layout pays there is
measured by ``chip_smoke.py`` phase 14, and the models do not use it.

Kernel math: for output fine pixel o = f_out*O + a and tap d of a stride-s
conv with low padding p, the input fine index is i = s*o + d - p. Writing
i = f_in*I + c splits it into a coarse tap t = floor((s*a + d - p)/f_in)
and an input slot c = (s*a + d - p) mod f_in, so the packed conv has stride
S = s*f_out/f_in (integral), coarse kernel size K = t_max - t_min + 1, low
padding P = -t_min, and block-structured weights
W'[(a, co), (c, ci), t] = w[co, ci, d]. Zero padding commutes with packing
(a zero coarse cell is f_in zero fine pixels), so equality is exact.

These are plain tensor functions: no TPU kernel of the JAX package reaches
them, and cuDNN runs their convolutions.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contrad_tpu_torch.ops import device_constant
from contrad_tpu_torch.ops.upfirdn2d import _is_separable, separate


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C); channel index (a_y*f + a_x)*C + c."""
    if f == 1:
        return x
    b, h, w, c = x.shape
    if h % f or w % f:
        raise ValueError(f"space_to_depth: {tuple(x.shape)} by {f}")
    x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    if f == 1:
        return x
    b, hh, ww, cc = x.shape
    c = cc // (f * f)
    x = x.reshape(b, hh, ww, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh * f, ww * f, c)


def _axis_geometry(k: int, f_in: int, f_out: int, stride: int,
                   p_lo: int, l: int = 1) -> Tuple[int, int, int]:
    """(S, K, P_lo) of the packed conv along one spatial axis.

    ``l`` is the lhs_dilation of the original conv (transpose-conv
    upsampling): only taps with (stride*a + d - p_lo) % l == 0 touch a real
    input pixel; their fine input index is (stride*a + d - p_lo) / l.
    """
    if (stride * f_out) % (l * f_in):
        raise ValueError(f"no packed conv for stride {stride}, f_in {f_in}, "
                         f"f_out {f_out}, lhs_dilation {l}")
    S = stride * f_out // (l * f_in)
    pos = np.add.outer(stride * np.arange(f_out), np.arange(k)) - p_lo
    pos = pos[pos % l == 0] // l
    t = pos // f_in
    K = int(t.max() - t.min() + 1)
    return S, K, int(-t.min())


@functools.lru_cache(maxsize=None)
def _selection(k: int, f_in: int, f_out: int, stride: int, p_lo: int,
               l: int) -> Tuple[Tuple[float, ...], Tuple[int, ...], int, int,
                                int]:
    """The constant 0/1 tensor T[ty, tx, cy, cx, ay, ax, dy, dx] (tap d of
    output slot a reads coarse tap t, input slot c; the outer product of
    the two axes' tensors) as flat values and a shape, with (S, K, P_lo)."""
    S, K, P_lo = _axis_geometry(k, f_in, f_out, stride, p_lo, l)
    T1 = np.zeros((K, f_in, f_out, k), np.float32)
    for a in range(f_out):
        for d in range(k):
            pos = stride * a + d - p_lo
            if pos % l:
                continue
            i = pos // l
            T1[i // f_in + P_lo, i % f_in, a, d] = 1.0
    T = np.einsum("tcad,TCAD->tTcCaAdD", T1, T1)
    return tuple(T.ravel().tolist()), T.shape, S, K, P_lo


def pack_conv_kernel(
    w: torch.Tensor,
    f_in: int,
    f_out: int,
    stride: int,
    pad: Tuple[int, int],
    lhs_dilation: int = 1,
) -> Tuple[torch.Tensor, int, Tuple[int, int]]:
    """Transform an OIHW kernel so that

        conv(x, w, stride, pad, lhs_dilation) == depth_to_space(
            conv(space_to_depth(x, f_in), w', S, (P_lo, P_hi)), f_out)

    exactly (square kernels, zero padding). Returns ``(w', S, (P_lo, P_hi))``
    with ``w'`` OIHW (f_out*f_out*co, f_in*f_in*ci, K, K). With
    ``lhs_dilation`` (transpose-conv upsampling) the packed conv is
    dilation-free: the sub-pixel-convolution identity, generalised. The
    high pad ``P_hi = K - S - P_lo`` holds where the original conv maps
    H -> H*l/stride, as every StyleGAN2 resampling conv does.

    One contraction against the JAX package's constant 0/1 selection
    tensor, so each packed weight is a copy of one original weight (or 0).
    The tensor is made once per geometry, dtype and device
    (:func:`~contrad_tpu_torch.ops.device_constant`), so a CUDA graph can
    capture the call.
    """
    co, ci, k_h, k_w = w.shape
    if k_h != k_w:
        raise ValueError("pack_conv_kernel takes square kernels only")
    values, shape, S, K, P_lo = _selection(k_h, f_in, f_out, stride, pad[0],
                                           lhs_dilation)
    P_hi = K - S - P_lo
    T = device_constant(values, w.dtype, w.device).view(shape)
    wp = torch.einsum("tTcCaAdD,oidD->aAocCitT", T, w)
    wp = wp.reshape(f_out * f_out * co, f_in * f_in * ci, K, K)
    return wp, S, (P_lo, P_hi)


@functools.lru_cache(maxsize=None)
def _upsample_values(h: int, k1: Tuple[float, ...],
                     factor: int) -> Tuple[float, ...]:
    return tuple(_upsample_matrix(h, np.asarray(k1, np.float32),
                                  factor).ravel().tolist())


def _upsample_slices(h: int, k1: Tuple[float, ...], factor: int,
                     dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`_upsample_matrix` as (h, factor, h) Toeplitz slices on
    ``device``, made once per arguments."""
    return device_constant(_upsample_values(h, k1, factor), dtype,
                           device).view(h, factor, h)


def _upsample_matrix(h: int, k1: np.ndarray, factor: int) -> np.ndarray:
    """Static (factor*h, h) matrix of the 1-D FIR upsample: zero-stuff by
    ``factor``, pad per ``upfirdn2d.upsample2d``'s arithmetic, correlate with
    ``k1`` (already x ``factor``-scaled). U[i, j] = k1[factor*j - i + pad0]."""
    kb = k1.shape[0]
    p = kb - factor
    pad0 = (p + 1) // 2 + factor - 1
    u = np.zeros((factor * h, h), np.float32)
    i = np.arange(factor * h)[:, None]
    j = np.arange(h)[None, :]
    t = factor * j - i + pad0
    ok = (t >= 0) & (t < kb)
    u[ok] = k1[t[ok]]
    return u


def upsample2d_packed(x: torch.Tensor, kernel: np.ndarray,
                      factor: int = 2) -> torch.Tensor:
    """``upsample2d(x, kernel, factor)`` with the output left packed by
    ``factor``. A separable kernel (every StyleGAN2 blur) takes two
    contractions against static (H, f, H) Toeplitz slices, the packed slot
    dims falling out contiguous; any other takes the packed dense-diagonal
    conv with ``lhs_dilation = factor``."""
    k = np.asarray(kernel, np.float32) * (factor**2)
    kb = k.shape[0]
    if _is_separable(k):
        b, h, w, c = x.shape
        kh, kw = separate(k)
        uh = _upsample_slices(h, tuple(kh.tolist()), factor, x.dtype,
                              x.device)
        uw = _upsample_slices(w, tuple(kw.tolist()), factor, x.dtype,
                              x.device)
        z = torch.einsum("HAk,bkwc->bHwAc", uh, x)
        z = torch.einsum("WBk,bHkAc->bHWABc", uw, z)
        return z.reshape(b, h, w, factor * factor * c)
    p = kb - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2 + factor - 1)
    c = x.shape[-1]
    wd = np.zeros((c, c, kb, kb), np.float32)
    wd[np.arange(c), np.arange(c)] = k
    wd = device_constant(tuple(wd.ravel().tolist()), x.dtype,
                         x.device).view(wd.shape)
    return packed_conv(x, wd, 1, factor, 1, pad, lhs_dilation=factor)


def packed_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    f_in: int,
    f_out: int,
    stride: int,
    pad: Tuple[int, int],
    lhs_dilation: int = 1,
) -> torch.Tensor:
    """conv(unpack(x), w)[packed]: ``x`` is the f_in-packed NHWC input,
    ``w`` the original OIHW kernel; the result is the f_out-packed output
    of the original (stride, pad, lhs_dilation) conv, through ``F.conv2d``
    on the NCHW view (equal pads in the conv, others by ``F.pad``, where
    a negative pad crops)."""
    wp, S, (p_lo, p_hi) = pack_conv_kernel(w.to(x.dtype), f_in, f_out,
                                           stride, pad, lhs_dilation)
    xc = x.permute(0, 3, 1, 2)
    if p_lo == p_hi >= 0:
        return F.conv2d(xc, wp, stride=S, padding=p_lo).permute(0, 2, 3, 1)
    xc = F.pad(xc, (p_lo, p_hi, p_lo, p_hi))
    return F.conv2d(xc, wp, stride=S).permute(0, 2, 3, 1)
