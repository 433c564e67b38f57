"""Separable 2-D FIR blur: the port of the TPU kernel
``contrad_tpu/ops/pallas_blur.py::pallas_blur2d`` (``pl.pallas_call`` at
``pallas_blur.py:116``).

``y = corr(zero_pad(x, pad), taps_v (x) taps_h)`` on NHWC tensors, vertical
taps first, f32 accumulation; output per dim ``size + pad0 + pad1 - k + 1``.

* On a CUDA tensor, ``blur2d`` launches the hand-written kernel in
  ``csrc/blur2d.cu`` (float32 or bfloat16, any C, k <= 4). It is bound by
  device-memory bytes; the source says what its design does about that.
  ``launch_plan`` chooses, in plain Python, the kernel's path (16-byte
  channel packs, or one channel at a time where C or the data's alignment
  does not allow them) and its work split. The kernel is compiled with
  ``nvcc`` for ``sm_90a`` at first use into ``contrad_tpu_torch/_build/``
  and bound with ``ctypes``.
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
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from contrad_tpu_torch.ops import device_constant, nvcc

_SOURCE = nvcc.CSRC / "blur2d.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 4

# The kernel's work split (csrc/blur2d.cu says why): blocks of at most
# _MAX_THREADS threads, each thread one 16-byte pack of one output column, a
# block at most 32 packs across the channels; strips of output rows cut
# until the grid holds about _GRID_BLOCKS blocks (eight per SM on 132 SMs),
# but no shorter than _MIN_ROWS rows, below which the k - 1 halo rows read
# again and the ring's fill cost more than the extra blocks gain, unless the
# grid would then hold fewer than _FILL_BLOCKS blocks (two per SM) and leave
# SMs idle.
_MAX_THREADS = 256  # csrc/blur2d.cu kMaxThreads
_MAX_PACKS = 32
_STAGES = 4  # csrc/blur2d.cu kStages
_GRID_BLOCKS = 8 * 132
_FILL_BLOCKS = 2 * 132
_MIN_ROWS = 8
_PACK_BYTES = 16

_library = None  # the loaded ctypes library, built once per process


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class LaunchPlan(NamedTuple):
    """What one kernel launch does; field for field ``Plan`` in
    ``csrc/blur2d.cu``. The grid is ``(strips * nseg * csplit, n)``."""
    n: int
    h: int
    w: int
    c: int
    ho: int
    wo: int
    pad0: int
    k: int
    dtype: int  # 0 float32, 1 bfloat16
    vector: int  # 1: 16-byte packs of channels; 0: one channel a pack
    groups: int  # packs per pixel
    gb: int  # packs per block
    csplit: int  # blocks across the packs of a pixel
    wseg: int  # output columns per block
    nseg: int  # blocks across the output width
    rows: int  # output rows per block (a strip)
    strips: int  # blocks down the output height
    threads: int  # per block, a multiple of 32
    smem: int  # bytes of the row ring per block
    device: int


class _PlanStruct(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in LaunchPlan._fields]


def launch_plan(shape: Sequence[int], k: int, pad: Tuple[int, int],
                dtype: torch.dtype, aligned: bool = True,
                device: int = 0) -> LaunchPlan:
    """The kernel's path and work split for an NHWC input of ``shape`` with
    a non-empty output: 16-byte packs where every pixel's channels start
    16-byte aligned (C * itemsize % 16 == 0 and ``aligned`` data), else one
    channel a pack; then blocks fitted to the output (``csrc/blur2d.cu``)."""
    n, h, w, c = (int(s) for s in shape)
    if n > 65535:  # the grid's y dimension
        raise ValueError(f"blur2d kernel takes at most 65535 images, got {n}")
    if w * c >= 2**31:
        raise ValueError(f"blur2d kernel takes rows of < 2**31 elements, "
                         f"got {w} x {c}")
    item = dtype.itemsize
    ho, wo = _out_size(h, k, pad), _out_size(w, k, pad)
    vector = aligned and (c * item) % _PACK_BYTES == 0
    vec = _PACK_BYTES // item if vector else 1
    groups = c // vec
    gb = _cdiv(groups, _cdiv(groups, _MAX_PACKS))
    csplit = _cdiv(groups, gb)
    nseg = _cdiv(wo * gb, _MAX_THREADS)
    while _cdiv(_cdiv(wo, nseg) * gb, 32) * 32 > _MAX_THREADS:
        nseg += 1
    wseg = _cdiv(wo, nseg)
    nseg = _cdiv(wo, wseg)
    base = n * nseg * csplit  # blocks per strip
    rows = min(ho, max(_MIN_ROWS, _cdiv(ho, _cdiv(_GRID_BLOCKS, base))))
    if base * _cdiv(ho, rows) < _FILL_BLOCKS:
        rows = _cdiv(ho, min(ho, _cdiv(_FILL_BLOCKS, base)))
    strips = _cdiv(ho, rows)
    return LaunchPlan(
        n=n, h=h, w=w, c=c, ho=ho, wo=wo, pad0=pad[0], k=k,
        dtype=_DTYPE_CODES[dtype], vector=int(vector), groups=groups, gb=gb,
        csplit=csplit, wseg=wseg, nseg=nseg, rows=rows, strips=strips,
        threads=_cdiv(wseg * gb, 32) * 32,
        smem=_STAGES * (wseg + k - 1) * gb * vec * item, device=device)


@functools.lru_cache(maxsize=None)
def _plan_struct(shape, k, pad, dtype, aligned, device) -> _PlanStruct:
    return _PlanStruct(*launch_plan(shape, k, pad, dtype, aligned, device))


@functools.lru_cache(maxsize=None)
def _taps_array(taps_v, taps_h):
    return (ctypes.c_float * (2 * len(taps_v)))(*taps_v, *taps_h)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/blur2d.cu`` (once per source hash) and load it."""
    global _library
    if _library is None:
        _library = nvcc.build(_SOURCE, {"blur2d_nhwc": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_PlanStruct),
             ctypes.POINTER(ctypes.c_float), ctypes.c_void_p],
            ctypes.c_int)}, verbose)
    return _library


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
    wv = device_constant(tuple(taps_v), acc, x.device)
    wh = device_constant(tuple(taps_h), acc, x.device)
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
    k = len(taps_v)
    y = torch.empty((n, _out_size(h, k, pad), _out_size(w, k, pad), c),
                    dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    plan = _plan_struct(tuple(x.shape), k, pad, x.dtype,
                        x.data_ptr() % _PACK_BYTES == 0, x.device.index)
    err = (_library or build()).blur2d_nhwc(
        x.data_ptr(), y.data_ptr(), ctypes.byref(plan),
        _taps_array(taps_v, taps_h),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blur2d kernel launch failed: CUDA error {err}")
    blur2d.launches += 1
    blur2d.scalar_launches += not plan.vector
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
    differentiable. ``blur2d.launches`` counts CUDA kernel launches, and
    ``blur2d.scalar_launches`` those of them that took the scalar path."""
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
blur2d.scalar_launches = 0
