"""StyleGAN3's filtered leaky ReLU: bias, upsample, leaky ReLU with a gain
and a clamp, downsample, in one op (Karras et al. 2021, "Alias-Free
Generative Adversarial Networks"; NVlabs ``torch_utils/ops/filtered_lrelu``).

For a channels-last ``x`` (N, H, W, C), a bias ``b`` (C,) and the 1-D
low-pass filters ``fu`` (up) and ``fd`` (down), per spatial axis:

* ``t = x + b``;
* upsample: insert ``up - 1`` zeros after each sample, pad by ``padding``
  (negative crops), correlate with ``fu * up`` (so ``up**2`` in 2-D, as
  NVlabs' ``upfirdn2d(..., gain=up**2)``);
* ``a = clamp(leaky_relu(u, slope) * gain, -clamp, clamp)`` on the 2-D
  upsampled grid;
* downsample: correlate with ``fd`` and keep every ``down``-th sample.

The filters are correlated as given; the Kaiser filters of
:func:`lowpass_filter` are symmetric, so this is NVlabs' convolution.
``padding`` is ``(x_lo, x_hi, y_lo, y_hi)``; a filter of one tap is None.

* On a CUDA tensor, :func:`filtered_lrelu` runs the hand-written kernel of
  ``csrc/filtered_lrelu.cu`` (float32 or bfloat16, float32 arithmetic)
  through an autograd ``Function``. The forward never writes the upsampled
  grid to memory; it keeps, besides its output, two bits a value of that
  grid (the leaky ReLU's branch and the clamp), from which the backward,
  the same up-act-down shape with the filters' roles swapped, takes the
  activation's derivative. The bias gradient is the sum of ``dx`` over N, H
  and W. There is no double backward (R1 differentiates D alone). The
  kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
  ``contrad_tpu_torch/_build/`` and bound with ``ctypes``.
* On a CPU tensor it runs :func:`filtered_lrelu_plain`: upfirdn as
  depthwise convolutions, the activation, upfirdn, with PyTorch's autograd.
  Any other device raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from contrad_tpu_torch.ops import device_constant, nvcc

_SOURCE = nvcc.CSRC / "filtered_lrelu.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FWD, BWD = 0, 1  # the kernel's modes
GROUP = 8  # csrc/filtered_lrelu.cu kGroup: channels a slot, and a sign word
MAX_TAPS = 24  # csrc/filtered_lrelu.cu kMaxTaps
# (up, down, taps up, taps down) that the kernel is built for: StyleGAN3's
# layers (filter size 6 times the factor) and the adjoints of their
# resampling; each with its tile (csrc/filtered_lrelu.cu says why)
SHAPES = {(1, 1, 1, 1), (2, 2, 12, 12), (4, 2, 24, 12), (2, 4, 12, 24)}

Taps = Optional[Tuple[float, ...]]
Padding = Tuple[int, int, int, int]

_library = None


def lowpass_filter(numtaps: int, cutoff: float, width: float,
                   fs: float) -> Optional[np.ndarray]:
    """A Kaiser-windowed low-pass FIR filter, ``scipy.signal.firwin(numtaps,
    cutoff, width=width, fs=fs)`` written out: ``h = 2c sinc(2c (n - (N -
    1) / 2)) kaiser(N, beta)`` with ``c = cutoff / fs``, ``beta`` by Kaiser's
    rule from the attenuation ``2.285 (N - 1) pi width / (fs / 2) + 7.95``,
    normalised to sum 1; float32. None for one tap (the identity)."""
    if numtaps < 1:
        raise ValueError(f"numtaps must be at least 1, got {numtaps}")
    if numtaps == 1:
        return None
    nyq = fs / 2.0
    atten = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = (cutoff / nyq) * np.sinc((cutoff / nyq) * m)
    h = h * np.kaiser(numtaps, beta)
    return (h / h.sum()).astype(np.float32)


class Geometry(NamedTuple):
    """The sizes of one call on a (H, W) input: the output's, and the
    upsampled grid's that the downsampling reads (``grid_h``, ``grid_w``)."""
    h_out: int
    w_out: int
    grid_h: int
    grid_w: int


def geometry(h: int, w: int, up: int, down: int, taps_up: int,
             taps_down: int, padding: Padding) -> Geometry:
    px0, px1, py0, py1 = padding
    full_h = h * up + py0 + py1 - taps_up + 1
    full_w = w * up + px0 + px1 - taps_up + 1
    h_out = (full_h - taps_down) // down + 1
    w_out = (full_w - taps_down) // down + 1
    if h_out < 1 or w_out < 1:
        raise ValueError(f"filtered_lrelu of a {h}x{w} input with padding "
                         f"{padding} gives no output")
    return Geometry(h_out, w_out, (h_out - 1) * down + taps_down,
                    (w_out - 1) * down + taps_down)


def branches(signs: torch.Tensor, c: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The forward's sign words (N, ceil(C / 8), grid_h, grid_w) as bools
    (N, C, grid_h, grid_w): ``(negative, clamped)``, the leaky ReLU's
    branch and the clamp of each value of the upsampled grid (bit ``k`` of
    a word is channel ``k`` of its group's branch, bit ``8 + k`` its
    clamp)."""
    w = signs.to(torch.int32) & 0xFFFF
    n, g, h, ww = w.shape
    bits = torch.arange(GROUP, device=w.device).view(1, 1, GROUP, 1, 1)

    def bit(shift):
        out = (w[:, :, None] >> (bits + shift)) & 1
        return out.reshape(n, g * GROUP, h, ww)[:, :c].bool()

    return bit(0), bit(GROUP)


# ---------------------------------------------------------------- plain op


def _fir(x: torch.Tensor, taps: Taps, down: int) -> torch.Tensor:
    """NCHW ``x`` correlated with ``taps`` along H, then along W (valid
    part), keeping every ``down``-th sample; depthwise convolutions."""
    if taps is not None:
        c, n = x.shape[1], len(taps)
        f = device_constant(tuple(taps), x.dtype, x.device)
        x = F.conv2d(x, f.view(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
        x = F.conv2d(x, f.view(1, 1, 1, n).expand(c, 1, 1, n), groups=c)
    return x[:, :, ::down, ::down] if down > 1 else x


def filtered_lrelu_plain(x: torch.Tensor, bias: Optional[torch.Tensor],
                         fu: Taps, fd: Taps, up: int = 1, down: int = 1,
                         padding: Padding = (0, 0, 0, 0),
                         gain: float = math.sqrt(2.0), slope: float = 0.2,
                         clamp: Optional[float] = None) -> torch.Tensor:
    """The op in plain PyTorch on any device (see the module docstring):
    upfirdn, the activation, upfirdn; differentiable by autograd."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    t = x.permute(0, 3, 1, 2)
    if up > 1:
        n, c, h, w = t.shape
        z = t.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = t
        t = z.reshape(n, c, h * up, w * up)
    t = F.pad(t, list(padding))
    u = _fir(t, None if fu is None else tuple(v * up for v in fu), 1)
    a = torch.where(u < 0, u * slope, u) * gain
    if clamp is not None:
        a = torch.clamp(a, -clamp, clamp)
    return _fir(a, fd, down).permute(0, 2, 3, 1)


# ---------------------------------------------------------------- kernel


class _Params(ctypes.Structure):
    """Field for field ``FlrParams`` in ``csrc/filtered_lrelu.cu``."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("x", "bias", "y",
                                                      "signs")]
                + [(name, ctypes.c_int) for name in (
                    "n", "c", "h_in", "w_in", "h_out", "w_out", "grid_h",
                    "grid_w", "py", "px", "qy", "qx", "up", "down",
                    "taps_up", "taps_down", "phase", "mode", "dtype",
                    "device", "tiles_x", "tiles_y", "groups")]
                + [(name, ctypes.c_float) for name in ("gain", "slope",
                                                       "clamp")]
                + [("fu", ctypes.c_float * MAX_TAPS),
                   ("fd", ctypes.c_float * MAX_TAPS)])


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/filtered_lrelu.cu`` (once per source hash) and load
    it."""
    global _library
    if _library is None:
        _library = nvcc.build(_SOURCE, {"filtered_lrelu_nhwc": (
            [ctypes.POINTER(_Params), ctypes.c_void_p], ctypes.c_int)},
            verbose)
    return _library


def _taps(f: Taps, scale: float = 1.0) -> Tuple[float, ...]:
    return (1.0,) if f is None else tuple(float(v) * scale for v in f)


def _launch(mode: int, x: torch.Tensor, bias: Optional[torch.Tensor],
            signs: Optional[torch.Tensor], fu: Sequence[float],
            fd: Sequence[float], up: int, down: int,
            pads: Tuple[int, int, int, int], out_hw: Tuple[int, int],
            grid_hw: Tuple[int, int], gain: float, slope: float,
            clamp: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One kernel launch on contiguous NHWC ``x``: ``(y, signs)``. ``fu``
    and ``fd`` are the taps as the kernel correlates them (gains folded
    in); ``pads`` ``(py, px, qy, qx)``: the upsampling's low pads and the
    downsampling's offsets on the grid; mode FWD allocates and writes
    ``signs``, mode BWD reads them."""
    n, h, w, c = x.shape
    if (up, down, len(fu), len(fd)) not in SHAPES:
        raise ValueError(f"filtered_lrelu kernel is built for (up, down, "
                         f"taps up, taps down) in {sorted(SHAPES)}, got "
                         f"{(up, down, len(fu), len(fd))}")
    if n > 65535 or -(-c // GROUP) > 65535:
        raise ValueError(f"filtered_lrelu kernel takes at most 65535 images "
                         f"and {65535 * GROUP} channels, got {n} x {c}")
    y = torch.empty((n,) + tuple(out_hw) + (c,), dtype=x.dtype,
                    device=x.device)
    if mode == FWD:
        signs = torch.empty((n, -(-c // GROUP)) + tuple(grid_hw),
                            dtype=torch.int16, device=x.device)
    py, px, qy, qx = pads
    p = _Params(
        x=x.data_ptr(), bias=None if bias is None else bias.data_ptr(),
        y=y.data_ptr(), signs=signs.data_ptr(), n=n, c=c, h_in=h, w_in=w,
        h_out=out_hw[0], w_out=out_hw[1], grid_h=grid_hw[0],
        grid_w=grid_hw[1], py=py, px=px, qy=qy, qx=qx, up=up, down=down,
        taps_up=len(fu), taps_down=len(fd), phase=(py - qy) % up, mode=mode,
        dtype=_DTYPE_CODES[x.dtype], device=x.device.index or 0,
        gain=gain, slope=slope, clamp=clamp)
    p.fu[:len(fu)] = list(fu)
    p.fd[:len(fd)] = list(fd)
    err = (_library or build()).filtered_lrelu_nhwc(
        ctypes.byref(p), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: CUDA "
                           f"error {err}")
    filtered_lrelu.launches += 1
    return y, signs


class _FilteredLReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, fu, fd, up, down, padding, gain, slope, clamp):
        n, h, w, c = x.shape
        lu, ld = len(_taps(fu)), len(_taps(fd))
        geo = geometry(h, w, up, down, lu, ld, padding)
        y, signs = _launch(
            FWD, x.contiguous(), b, None, _taps(fu, up), _taps(fd), up, down,
            (padding[2], padding[0], 0, 0), (geo.h_out, geo.w_out),
            (geo.grid_h, geo.grid_w), gain, slope, clamp)
        ctx.save_for_backward(signs)
        ctx.consts = (fu, fd, up, down, padding, gain, slope, clamp, (h, w),
                      geo)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        (signs,) = ctx.saved_tensors
        fu, fd, up, down, padding, gain, slope, clamp, hw, geo = ctx.consts
        lu, ld = len(_taps(fu)), len(_taps(fd))
        # the adjoint: upsample dy by ``down`` with fd reversed, the
        # activation's derivative from the signs, then correlate with fu
        # reversed (times up) and keep every ``up``-th sample
        dx, _ = _launch(
            BWD, dy.contiguous(), None, signs, _taps(fd)[::-1],
            _taps(fu, up)[::-1], down, up,
            (ld - 1, ld - 1, padding[2] - lu + 1, padding[0] - lu + 1), hw,
            (geo.grid_h, geo.grid_w), gain, slope, clamp)
        db = None
        if ctx.needs_input_grad[1]:
            db = dx.reshape(-1, dx.shape[-1]).sum(
                0, dtype=torch.float32).to(dx.dtype)
        return dx, db, None, None, None, None, None, None, None, None


def filtered_lrelu(x: torch.Tensor, bias: Optional[torch.Tensor], fu: Taps,
                   fd: Taps, up: int = 1, down: int = 1,
                   padding: Padding = (0, 0, 0, 0),
                   gain: float = math.sqrt(2.0), slope: float = 0.2,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """The filtered leaky ReLU of channels-last ``x`` (see the module
    docstring): the kernel on a CUDA tensor, the plain op on a CPU one.
    ``fu`` and ``fd`` are 1-D taps (tuples of floats, None for one tap).
    ``filtered_lrelu.launches`` counts the kernel's launches (a forward 1,
    a gradient 1); ``filtered_lrelu.scalar_launches`` stays 0: the kernel
    has one path for every shape it takes, and no scalar fallback."""
    if x.device.type == "cpu":
        return filtered_lrelu_plain(x, bias, fu, fd, up, down, padding,
                                    gain, slope, clamp)
    if not x.is_cuda:
        raise RuntimeError(f"filtered_lrelu runs on cuda or cpu, not "
                           f"{x.device}")
    if x.dtype not in _DTYPE_CODES or x.dim() != 4:
        raise TypeError(f"filtered_lrelu kernel takes a float32 or bfloat16 "
                        f"NHWC tensor, got {x.dtype} {tuple(x.shape)}")
    b = None
    if bias is not None:
        if tuple(bias.shape) != (x.shape[-1],) or bias.device != x.device:
            raise ValueError(f"filtered_lrelu bias must be ({x.shape[-1]},) "
                             f"on {x.device}, got {tuple(bias.shape)} on "
                             f"{bias.device}")
        b = bias.to(x.dtype).contiguous()
    clamp = math.inf if clamp is None else float(clamp)
    return _FilteredLReLU.apply(x, b, fu, fd, int(up), int(down),
                                tuple(int(v) for v in padding), float(gain),
                                float(slope), clamp)


filtered_lrelu.launches = 0
filtered_lrelu.scalar_launches = 0
