"""The control of a bfloat16 mix: the plain reference computed a precision
below bfloat16, as a float8 train step would take it. Inside
``float8_products()`` every convolution and matrix product of the
reference (``torch.conv2d``, ``conv_transpose2d``, ``linear``, ``matmul``
and ``@``) takes its two operands rounded to float8 e4m3, and the
gradient that reaches its output rounded to float8 e5m2, each under a
per-tensor scale that maps the largest magnitude to the format's largest;
products accumulate, and every other operation runs, in float32. The
rounding passes gradients straight through, to any order (R1's double
backward)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

FORWARD, BACKWARD = torch.float8_e4m3fn, torch.float8_e5m2
PRODUCTS = {torch.conv2d, torch.conv_transpose2d, F.linear, torch.matmul,
            torch.Tensor.matmul}


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale, back
    in ``x``'s dtype."""
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, torch.finfo(dtype).max / amax,
                        torch.ones_like(amax))
    return ((x * scale).to(dtype).to(x.dtype) / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: rounded to e4m3; backward: straight through."""

    @staticmethod
    def forward(ctx, x):
        return rounded(x, FORWARD)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gradient(torch.autograd.Function):
    """Forward: the identity; backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _Rounded.apply(g)


class _Rounded(torch.autograd.Function):
    """Forward: rounded to e5m2; backward: straight through."""

    @staticmethod
    def forward(ctx, g):
        return rounded(g, BACKWARD)

    @staticmethod
    def backward(ctx, h):
        return h


def _float(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


class _Float8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in PRODUCTS:
            return func(*args, **kwargs)
        ops = [_Operand.apply(a) if _float(a) else a for a in args[:2]]
        return _Gradient.apply(func(*ops, *args[2:], **kwargs))


@contextlib.contextmanager
def float8_products():
    with _Float8Products():
        yield
