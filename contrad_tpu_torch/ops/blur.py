"""Separable 2-D FIR blur: the port of the TPU kernel
``contrad_tpu/ops/pallas_blur.py::pallas_blur2d`` (``pl.pallas_call`` at
``pallas_blur.py:116``).

``y = corr(zero_pad(x, pad), taps_v (x) taps_h)`` on NHWC tensors, vertical
taps first, f32 accumulation; output per dim ``size + pad0 + pad1 - k + 1``.

* On a CUDA tensor, ``blur2d`` launches the hand-written kernel in
  ``csrc/blur2d.cu`` (float32 or bfloat16, any C, k <= 4). It is bound by
  device-memory bytes; the source says what its design does about that. The
  kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
  ``contrad_tpu_torch/_build/`` and bound with ``ctypes``.
* On a CPU tensor it runs ``blur2d_plain``, the same function as padding plus
  two depthwise convolutions. Any other device raises.

Gradient: the adjoint of a zero-padded correlation is the correlation of the
gradient with the reversed taps and the complementary pads
``(k - 1 - pad0, k - 1 - pad1)``. ``_Blur2d.backward`` therefore applies
``_Blur2d`` again, so the op is differentiable to any order (the R1 penalty
takes a gradient of a gradient through D). Both pads must lie in
``[0, k - 1]`` for the adjoint to be a blur of the same kind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "blur2d.cu"
_BUILD_DIR = _PKG / "_build"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 4

_library = None  # the loaded ctypes library, built once per process


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/blur2d.cu`` (once per source hash) and load it."""
    global _library
    if _library is not None:
        return _library
    source = _SOURCE.read_bytes()
    target = _BUILD_DIR / f"libblur2d_{hashlib.sha1(source).hexdigest()[:12]}.so"
    if not target.exists():
        _BUILD_DIR.mkdir(exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(_SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    lib.blur2d_nhwc.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8
        + [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p])
    lib.blur2d_nhwc.restype = ctypes.c_int
    _library = lib
    return lib


def _out_size(size: int, k: int, pad: Tuple[int, int]) -> int:
    return size + pad[0] + pad[1] - k + 1


def blur2d_plain(x: torch.Tensor, taps_v: Sequence[float],
                 taps_h: Sequence[float], pad: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version on any device: zero pad, then a vertical and a
    horizontal depthwise correlation in f32 (or wider); returns x's dtype."""
    c = x.shape[-1]
    k = len(taps_v)
    acc = torch.promote_types(x.dtype, torch.float32)
    xc = x.permute(0, 3, 1, 2).to(acc)
    xc = F.pad(xc, (pad[0], pad[1], pad[0], pad[1]))
    wv = torch.tensor(taps_v, dtype=acc, device=x.device)
    wh = torch.tensor(taps_h, dtype=acc, device=x.device)
    xc = F.conv2d(xc, wv.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    xc = F.conv2d(xc, wh.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return xc.to(x.dtype).permute(0, 2, 3, 1)


def _launch(x: torch.Tensor, taps_v, taps_h, pad) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"blur2d kernel takes float32 or bfloat16, got {x.dtype}")
    if len(taps_v) > _MAX_TAPS:
        raise ValueError(f"blur2d kernel takes at most {_MAX_TAPS} taps")
    x = x.contiguous()
    n, h, w, c = x.shape
    if n > 65535:  # the grid's z dimension
        raise ValueError(f"blur2d kernel takes at most 65535 images, got {n}")
    k = len(taps_v)
    ho, wo = _out_size(h, k, pad), _out_size(w, k, pad)
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build()
    taps = (ctypes.c_float * (2 * k))(*taps_v, *taps_h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.blur2d_nhwc(x.data_ptr(), y.data_ptr(), n, h, w, c, ho, wo,
                              pad[0], k, taps, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"blur2d kernel launch failed: CUDA error {err}")
    blur2d.launches += 1
    return y


class _Blur2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps_v, taps_h, pad):
        ctx.taps = (taps_v, taps_h)
        ctx.pad = pad
        if x.is_cuda:
            return _launch(x, taps_v, taps_h, pad)
        if x.device.type == "cpu":
            return blur2d_plain(x, taps_v, taps_h, pad)
        raise RuntimeError(f"blur2d runs on cuda or cpu, not {x.device}")

    @staticmethod
    def backward(ctx, grad):
        taps_v, taps_h = ctx.taps
        k = len(taps_v)
        adj_pad = (k - 1 - ctx.pad[0], k - 1 - ctx.pad[1])
        gx = _Blur2d.apply(grad, tuple(reversed(taps_v)),
                           tuple(reversed(taps_h)), adj_pad)
        return gx, None, None, None


def blur2d(x: torch.Tensor, taps_v: Sequence[float], taps_h: Sequence[float],
           pad: Tuple[int, int]) -> torch.Tensor:
    """Separable blur of an NHWC tensor; twice (indeed any times)
    differentiable. ``blur2d.launches`` counts CUDA kernel launches."""
    if x.dim() != 4:
        raise ValueError(f"blur2d takes an NHWC tensor, got shape {tuple(x.shape)}")
    taps_v = tuple(float(t) for t in taps_v)
    taps_h = tuple(float(t) for t in taps_h)
    k = len(taps_v)
    if len(taps_h) != k:
        raise ValueError("vertical and horizontal taps differ in length")
    pad = (int(pad[0]), int(pad[1]))
    if not all(0 <= p <= k - 1 for p in pad):
        raise ValueError(f"blur2d pads must lie in [0, {k - 1}], got {pad}")
    return _Blur2d.apply(x, taps_v, taps_h, pad)


blur2d.launches = 0
