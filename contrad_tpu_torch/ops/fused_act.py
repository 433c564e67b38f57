"""Bias + LeakyReLU with a sqrt(2) gain (the port of
``contrad_tpu/ops/fused_act.py``, an XLA elementwise expression there that
XLA fuses into one pass forward and one backward).

``out = leaky_relu(x + bias[channel], slope) * gain``, channels last.

* On a CUDA tensor, ``fused_leaky_relu`` runs the hand-written kernel in
  ``csrc/fused_act.cu`` (float32 or bfloat16, any C) through an autograd
  ``Function``: one pass forward, one pass backward that also gives the
  bias gradient. It is bound by device-memory bytes; the source says what
  its design does about that. ``launch_plan`` chooses, in plain Python, the
  kernel's path (16-byte channel packs, or one channel at a time where C or
  the data's alignment does not allow them) and its work split. The kernel
  is compiled with ``nvcc`` for ``sm_90a`` at first use into
  ``contrad_tpu_torch/_build/`` and bound with ``ctypes``. It takes a
  ``(C,)`` bias and a channels-last tensor dense in one of two memory
  layouts, channels innermost (contiguous) or channel planes (contiguous
  once the channels are moved to dim 1: NCHW memory, which cuDNN gives
  where its input had it, as D's images do), keeps that layout in its
  output, and raises on anything else. A gradient that arrives in the other
  layout than the forward's output is read through a transposing tile.
* On a CPU tensor it runs ``fused_leaky_relu_plain``, the three-operator
  expression, with PyTorch's autograd. Any other device raises.

Gradient: the forward saves only its output ``out``, whose sign is that of
``x + b`` since the gain is positive (so where the next layer saves its
input too, autograd keeps one tensor). The backward is the kernel's mode
``grad``: ``dx = dy * gain``, times the slope where ``out <= 0``, and ``db``
its sum over rows. That map is linear in ``dy`` and its derivative in
``out`` is zero (as ``leaky_relu_backward``'s in its input), and its
adjoint is the same mode with the upstream bias gradient as the bias:
``_Grad.backward`` applies ``_Grad`` again, so the op is differentiable to
any order with the one kernel (the R1 penalty takes a gradient of a
gradient through D).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch.ops import nvcc

_SOURCE = nvcc.CSRC / "fused_act.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT, GRAD = 0, 1  # the kernel's modes

# The kernel's work split (csrc/fused_act.cu says why): blocks of at most
# _MAX_THREADS threads, over whole rows of packs (channels innermost), over
# one channel's packs (channel planes), or over _TILE x _TILE tiles of
# channels and pixels (a gradient in the other layout); each thread issues
# _UNROLL packs of loads at a time (float32); the grid strides over the
# tensor with as many blocks as it fills, up to about _GRID_BLOCKS (four per
# SM on 132 SMs, what __launch_bounds__ keeps resident: one wave).
_MAX_THREADS = 256  # csrc/fused_act.cu kMaxThreads
_UNROLL = 4  # csrc/fused_act.cu kUnroll
_TILE = 32  # csrc/fused_act.cu kTile
_GRID_BLOCKS = 4 * 132
_PACK_BYTES = 16

_library = None  # the loaded ctypes library, built once per process


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class LaunchPlan(NamedTuple):
    """What one kernel launch does; field for field ``BiasActPlan`` in
    ``csrc/fused_act.cu``. The grid is ``(gx, gy)``. Memory is ``(rows, c,
    inner)``: channels innermost where ``inner`` is 1, else channel planes
    of ``inner`` values (``rows`` images); with ``transpose``, ``rows``
    images of ``inner`` pixels, the input in the other layout than ``ref``
    and the output (``planes``)."""
    rows: int
    c: int
    inner: int
    dtype: int  # 0 float32, 1 bfloat16
    vector: int  # 1: 16-byte packs; 0: one value a pack
    planes: int  # ref and out: 1 channel planes; 0 channels innermost
    transpose: int  # GRAD only: g in the other layout, through a tile
    mode: int  # ACT or GRAD
    has_bias: int
    partials: int  # GRAD only: the bias gradient's partial sums, then db
    packs: int  # packs per row (innermost) or per plane (planes)
    cw: int  # innermost: packs across a block
    ry: int  # innermost: rows a block takes at once
    threads: int  # per block (innermost: cw * ry)
    gx: int  # blocks along the rows or a channel's planes: partial rows
    gy: int  # blocks across a row's packs (innermost) or the channels
    device: int


class _PlanStruct(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in LaunchPlan._fields]


def launch_plan(rows: int, c: int, inner: int, dtype: torch.dtype,
                mode: int, has_bias: bool, partials: bool,
                aligned: bool = True, device: int = 0,
                transpose_to: Optional[bool] = None) -> LaunchPlan:
    """The kernel's path and work split for memory ``(rows, c, inner)``
    (``_layout``): 16-byte packs where every row's channels (``inner`` 1)
    or every plane (``inner`` > 1) holds a whole number of them and the
    data is 16-byte ``aligned``, else one value a pack; then blocks of
    whole rows of packs, or blocks of one channel's packs. With
    ``transpose_to`` (mode grad; the output's layout, True for channel
    planes) ``rows`` images of ``inner`` pixels through 32 x 32 tiles
    (``csrc/fused_act.cu``)."""
    if partials and mode != GRAD:
        raise ValueError("only mode grad sums the bias gradient")
    if transpose_to is not None:
        if mode != GRAD:
            raise ValueError("only mode grad reads another layout")
        gy = _cdiv(c, _TILE)
        tiles = rows * _cdiv(inner, _TILE)
        if gy > 65535 or rows * inner * c >= 2**62:
            raise ValueError(f"fused_leaky_relu kernel takes at most "
                             f"{65535 * _TILE} channels, got {c}")
        return LaunchPlan(
            rows=rows, c=c, inner=inner, dtype=_DTYPE_CODES[dtype], vector=0,
            planes=int(transpose_to), transpose=1, mode=mode,
            has_bias=int(has_bias), partials=int(partials), packs=0,
            cw=_TILE, ry=_MAX_THREADS // _TILE, threads=_MAX_THREADS,
            gx=max(1, min(tiles, _cdiv(_GRID_BLOCKS, gy))), gy=gy,
            device=device)
    item = dtype.itemsize
    planes = inner > 1
    span = inner if planes else c  # values a pack may not straddle
    vector = aligned and (span * item) % _PACK_BYTES == 0
    vec = _PACK_BYTES // item if vector else 1
    packs = span // vec
    if rows * (packs if planes else 1) >= 2**31 or c > 65535 * _MAX_THREADS:
        raise ValueError(f"fused_leaky_relu kernel takes < 2**31 rows of "
                         f"packs and fewer channels, got {rows} x {c} x "
                         f"{inner}")
    if planes:
        if c > 65535:  # the grid's y dimension
            raise ValueError(f"fused_leaky_relu kernel takes at most 65535 "
                             f"channel planes, got {c}")
        total = rows * packs  # a channel's packs
        threads = min(_MAX_THREADS, _cdiv(_cdiv(total, _UNROLL), 32) * 32)
        cw, ry, gy = threads, 1, c
        gx = max(1, min(_cdiv(total, threads * _UNROLL),
                        _cdiv(_GRID_BLOCKS, c)))
    else:
        cw = min(packs, _MAX_THREADS)
        ry = _MAX_THREADS // cw
        threads, gy = cw * ry, _cdiv(packs, cw)
        gx = max(1, min(_cdiv(_cdiv(rows, ry), _UNROLL),
                        _cdiv(_GRID_BLOCKS, gy)))
    return LaunchPlan(
        rows=rows, c=c, inner=inner, dtype=_DTYPE_CODES[dtype],
        vector=int(vector), planes=int(planes), transpose=0, mode=mode,
        has_bias=int(has_bias), partials=int(partials), packs=packs, cw=cw,
        ry=ry, threads=threads, gx=gx, gy=gy, device=device)


@functools.lru_cache(maxsize=None)
def _plan_struct(*args) -> _PlanStruct:
    return _PlanStruct(*launch_plan(*args))


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/fused_act.cu`` (once per source hash) and load it."""
    global _library
    if _library is None:
        _library = nvcc.build(_SOURCE, {"fused_act_nhwc": (
            [ctypes.c_void_p] * 6 + [ctypes.POINTER(_PlanStruct),
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_void_p],
            ctypes.c_int)}, verbose)
    return _library


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor | None = None,
                           negative_slope: float = 0.2,
                           scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """Plain PyTorch version on any device: the bias add, the leaky ReLU and
    the gain as three operators."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return F.leaky_relu(x, negative_slope) * scale


def _layout(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(rows, c, inner)`` of a channels-last tensor's memory: channels
    innermost ``(numel / C, C, 1)`` where it is contiguous; channel planes
    ``(N, C, numel / (N * C))`` where it is contiguous with its channels
    moved to dim 1; else None."""
    c = x.shape[-1]
    if x.numel() == 0 or x.is_contiguous():
        return x.numel() // max(c, 1), c, 1
    if x.dim() >= 3 and x.movedim(-1, 1).is_contiguous():
        return x.shape[0], c, x.numel() // (x.shape[0] * c)
    return None


def check(x: torch.Tensor, bias: Optional[torch.Tensor],
          scale: float) -> None:
    """Raise on what the kernel does not take: a dtype other than float32 or
    bfloat16, a tensor in neither memory layout (``_layout``), a bias that
    is not ``(C,)`` on x's device, a gain that is not positive."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_leaky_relu kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() < 1 or _layout(x) is None:
        raise ValueError(f"fused_leaky_relu kernel takes a channels-last "
                         f"tensor with its channels innermost or in planes, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if bias is not None and (tuple(bias.shape) != (x.shape[-1],)
                             or bias.device != x.device):
        raise ValueError(f"fused_leaky_relu bias must be ({x.shape[-1]},) on "
                         f"{x.device}, got {tuple(bias.shape)} on "
                         f"{bias.device}")
    if not scale > 0:
        raise ValueError(f"fused_leaky_relu kernel takes a positive gain, "
                         f"got {scale}")


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % _PACK_BYTES == 0 for t in tensors)


def _launch(mode: int, x: torch.Tensor, b: Optional[torch.Tensor],
            ref: Optional[torch.Tensor], slope: float, gain: float,
            want_db: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One kernel launch (and, for ``want_db``, the partial sums' one):
    ``(out, db)``, out in the memory layout of ``ref`` (mode grad) or of x;
    the tensors of one shape and dtype, on one card, each in either layout
    (``_layout``), ``b`` contiguous."""
    c = x.shape[-1]
    out = torch.empty_like(x if ref is None else ref)
    db = torch.empty(c, dtype=x.dtype, device=x.device) if want_db else None
    if x.numel() == 0:
        return out, None if db is None else db.zero_()
    layout = _layout(out)
    if _layout(x) == layout:
        plan = _plan_struct(*layout, x.dtype, mode, b is not None, want_db,
                            _aligned(x, b, ref), x.device.index or 0)
    else:
        n = x.shape[0]
        plan = _plan_struct(n, c, x.numel() // (n * c), x.dtype, mode,
                            b is not None, want_db, False,
                            x.device.index or 0, layout[2] > 1)
    partial = (torch.empty((plan.gx, c), dtype=torch.float32,
                           device=x.device) if want_db else None)
    ptr = [None if t is None else t.data_ptr()
           for t in (x, ref, b, out, partial, db)]
    err = (_library or build()).fused_act_nhwc(
        *ptr, ctypes.byref(plan), slope, gain,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_leaky_relu kernel launch failed: CUDA "
                           f"error {err}")
    fused_leaky_relu.launches += 1 + plan.partials
    fused_leaky_relu.scalar_launches += not (plan.vector or plan.transpose)
    return out, db


def _act(x, b, slope, gain) -> torch.Tensor:
    """Mode act: the kernel on the card, its plain version on the CPU."""
    if x.is_cuda:
        return _launch(ACT, x, b, None, slope, gain, False)[0]
    if x.device.type != "cpu":
        raise RuntimeError(f"fused_leaky_relu runs on cuda or cpu, not "
                           f"{x.device}")
    t = x if b is None else x + b
    return torch.where(t > 0, t, t * slope) * gain


def _grad(g, b, ref, slope, gain, want_db):
    """Mode grad: ``(y, db)``, y in ``ref``'s memory layout; the kernel on
    the card, its plain version on the CPU. A ``g`` in neither layout
    (``_layout``: a broadcast, a slice) is first copied into ``ref``'s."""
    g = g.to(ref.dtype)
    if _layout(g) is None:
        g = torch.empty_like(ref).copy_(g)
    b = None if b is None else b.to(ref.dtype).contiguous()
    if g.is_cuda:
        return _launch(GRAD, g, b, ref, slope, gain, want_db)
    if g.device.type != "cpu":
        raise RuntimeError(f"fused_leaky_relu runs on cuda or cpu, not "
                           f"{g.device}")
    y = torch.empty_like(ref).copy_((g if b is None else g + b) * gain)
    y = torch.where(ref > 0, y, y * slope)
    return y, (y.reshape(-1, y.shape[-1]).sum(0) if want_db else None)


class _Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, slope, gain):
        out = _act(x, b, slope, gain)
        ctx.save_for_backward(out)
        ctx.consts = (slope, gain)
        return out

    @staticmethod
    def backward(ctx, dy):
        (out,) = ctx.saved_tensors
        dx, db = _Grad.apply(dy, None, out.detach(), *ctx.consts,
                             ctx.needs_input_grad[1])
        return dx, db, None, None


class _Grad(torch.autograd.Function):
    """``(y, db)`` of mode grad from ``(g, b)``, ``ref`` held constant."""

    @staticmethod
    def forward(ctx, g, b, ref, slope, gain, want_db):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(ref)
        ctx.consts = (slope, gain)
        return _grad(g, b, ref, slope, gain, want_db)

    @staticmethod
    def backward(ctx, hy, hdb):
        (ref,) = ctx.saved_tensors
        if hy is None:
            hy = torch.zeros_like(ref)
        gy, gb = _Grad.apply(hy, hdb, ref, *ctx.consts,
                             ctx.needs_input_grad[1])
        return gy, gb, None, None, None, None


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """out = leaky_relu(x + bias[channel]) * scale; channels last; any
    times differentiable. ``fused_leaky_relu.launches`` counts CUDA kernel
    launches (a forward 1, a gradient 2 with the bias's, else 1), and
    ``fused_leaky_relu.scalar_launches`` the elementwise launches that took
    the scalar path."""
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    if not x.is_cuda:
        raise RuntimeError(f"fused_leaky_relu runs on cuda or cpu, not "
                           f"{x.device}")
    check(x, bias, scale)
    b = None if bias is None else bias.to(x.dtype)
    return _Act.apply(x, b, float(negative_slope), float(scale))


fused_leaky_relu.launches = 0
fused_leaky_relu.scalar_launches = 0


class FusedLeakyReLU(nn.Module):
    """Per-channel-bias leaky ReLU with sqrt(2) gain (StyleGAN2 convention)."""

    def __init__(self, channels: int, negative_slope: float = 0.2,
                 scale: float = math.sqrt(2.0)):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
