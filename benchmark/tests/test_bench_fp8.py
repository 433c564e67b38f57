"""The control of a bfloat16 mix (``reference/fp8.py``): inside
``float8_products()`` each convolution and matrix product takes its
operands rounded to float8 e4m3 and the gradient at its output rounded to
e5m2, under per-tensor scales, to any order of differentiation; outside it
nothing changes."""

from __future__ import annotations

import pytest


def test_rounding_keeps_e4m3s_and_e5m2s_precision():
    import torch

    from benchmark.reference.fp8 import BACKWARD, FORWARD, rounded

    g = torch.Generator().manual_seed(1)
    x = (torch.rand(4096, generator=g) * 0.5 + 0.5) * torch.sign(
        torch.randn(4096, generator=g)) * 3e-4
    for dtype, eps in ((FORWARD, 2.0**-4), (BACKWARD, 2.0**-3)):
        err = ((rounded(x, dtype) - x).abs() / x.abs()).max()
        assert 0 < float(err) <= eps
    assert float(rounded(x, FORWARD).abs().max()) == pytest.approx(
        float(x.abs().max()))
    assert torch.equal(rounded(torch.zeros(3), FORWARD), torch.zeros(3))


def test_products_take_rounded_operands_and_gradients():
    import torch
    import torch.nn.functional as F

    from benchmark.reference.fp8 import BACKWARD, FORWARD, float8_products, \
        rounded

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 8, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=g, requires_grad=True)
    a, b = torch.randn(5, 6, generator=g), torch.randn(6, 7, generator=g)
    with float8_products():
        y = F.conv2d(x, w, padding=1)
        ab = a @ b
        lin = F.linear(a, b.t())
        plain = torch.sin(a)
    assert torch.equal(y, F.conv2d(rounded(x.detach(), FORWARD),
                                   rounded(w.detach(), FORWARD), padding=1))
    assert torch.equal(ab, rounded(a, FORWARD) @ rounded(b, FORWARD))
    assert torch.equal(lin, ab)
    assert torch.equal(plain, torch.sin(a))
    assert not torch.equal(F.conv2d(x, w, padding=1), y)
    up = torch.randn(y.shape, generator=g)
    (gx,) = torch.autograd.grad(y, x, up)
    want = torch.nn.grad.conv2d_input(x.shape, rounded(w.detach(), FORWARD),
                                      rounded(up, BACKWARD), padding=1)
    assert torch.allclose(gx, want, rtol=1e-6, atol=1e-6)


def test_a_gradient_of_a_gradient_runs_through():
    """R1's shape: the input gradient with a graph, then its norm's
    gradient to the weights."""
    import torch
    import torch.nn.functional as F

    from benchmark.reference.fp8 import float8_products

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 8, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=g, requires_grad=True)
    with float8_products():
        d = F.leaky_relu(F.conv2d(x, w, padding=1), 0.2).sum()
        (gx,) = torch.autograd.grad(d, x, create_graph=True)
        (gw,) = torch.autograd.grad(gx.pow(2).sum(), w)
    assert torch.isfinite(gw).all() and float(gw.abs().sum()) > 0
