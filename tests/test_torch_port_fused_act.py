"""The port's fused activation (``contrad_tpu_torch/ops/fused_act.py``) on
the CPU: the plain op, which the wrapper runs for CPU tensors, against the
three-operator expression it has always been; the autograd ``Function``
that carries the CUDA kernel, on its plain path (the kernel's two modes as
PyTorch expressions), against that expression's and JAX's derivatives; the
wrapper's refusals; the launch plan; the launch counts. The kernel itself is
held to the plain op on the card by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.

Tolerances: float32 forwards and input gradients are bitwise (the same
operations in the same order); float64 derivatives 1e-12 (a bias gradient
summed in another order); JAX's float32 op 1e-6 relative (XLA's own
rounding of the sums)."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contrad_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from contrad_tpu_torch.models.stylegan2.generator import stylegan2_channels
from contrad_tpu_torch.ops import blur, filtered_lrelu, fused_act
from contrad_tpu_torch.training import graph

GAIN = math.sqrt(2.0)
SHAPES = [(2, 5, 3, 7), (4, 16), (3, 4, 4, 32)]


def old_expression(x, bias, slope=0.2, scale=GAIN):
    """The activation as the port computed it before the kernel."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return F.leaky_relu(x, slope) * scale


def function(x, b, slope=0.2, gain=GAIN):
    """The kernel's autograd Function, on its plain path for CPU tensors."""
    return fused_act._Act.apply(x, b, slope, gain)


def _inputs(shape, dtype, seed=0, bias=True, margin=0.0):
    """x and a (C,) bias; with ``margin`` no pre-activation lies within it
    of the kink, for finite differences."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    b = torch.randn(shape[-1], generator=gen, dtype=torch.float64)
    if margin:
        t = x + b
        x = x + margin * torch.where(t >= 0, 1.0, -1.0)
    return x.to(dtype), (b.to(dtype) if bias else None)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_op_and_function_equal_the_old_expression_bitwise(shape, bias):
    x, b = _inputs(shape, torch.float32, bias=bias)
    want = old_expression(x, b)
    assert torch.equal(fused_act.fused_leaky_relu(x, b), want)
    assert torch.equal(fused_act.fused_leaky_relu_plain(x, b), want)
    assert torch.equal(function(x, b), want)
    # the input gradient of mode grad, from the output alone
    xx = x.clone().requires_grad_(True)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(9))
    (dx,) = torch.autograd.grad(old_expression(xx, b), xx, dy)
    y, db = fused_act._grad(dy, None, want, 0.2, GAIN, True)
    assert torch.equal(y, dx)
    assert torch.equal(db, dx.reshape(-1, shape[-1]).sum(0))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_derivatives_match_the_old_expression(shape, bias):
    """First and second derivatives in float64 through
    ``torch.autograd.grad(..., create_graph=True)``: out, dx, db, and the
    derivatives of <dx, h> + <db, k> in dy (R1's path), x and the bias."""
    x, b = _inputs(shape, torch.float64, bias=bias)
    gen = torch.Generator().manual_seed(1)
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)
    h = torch.randn(shape, generator=gen, dtype=torch.float64)
    k = torch.randn(shape[-1], generator=gen, dtype=torch.float64)

    def derivatives(fn):
        xx = x.clone().requires_grad_(True)
        leaves = [xx] + ([b.clone().requires_grad_(True)] if bias else [])
        gg = dy.clone().requires_grad_(True)
        out = fn(xx, leaves[1] if bias else None)
        first = torch.autograd.grad(out, leaves, gg, create_graph=True)
        z = (first[0] * h).sum() + ((first[1] * k).sum() if bias else 0)
        second = torch.autograd.grad(z, [gg] + leaves, allow_unused=True,
                                     materialize_grads=True)
        return [out] + list(first) + list(second)

    for got, want in zip(derivatives(function),
                         derivatives(old_expression)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bias", [True, False])
def test_function_passes_gradcheck_to_third_order(bias):
    """Finite differences away from the kink: the Function, its gradient
    (``_Grad``) and the gradient's gradient."""
    x, b = _inputs((3, 4, 5), torch.float64, bias=bias, margin=0.1)
    args = (x.requires_grad_(True),) + ((b.requires_grad_(True),) if bias
                                        else ())

    def fn(x, b=None):
        return function(x, b)

    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)
    ref = fn(*args).detach()
    dy = torch.randn(ref.shape, dtype=torch.float64, requires_grad=True)
    db_in = torch.randn(ref.shape[-1], dtype=torch.float64,
                        requires_grad=True)

    def grad_mode(g, c):
        return fused_act._Grad.apply(g, c, ref, 0.2, GAIN, True)

    assert torch.autograd.gradcheck(grad_mode, (dy, db_in))
    assert torch.autograd.gradgradcheck(grad_mode, (dy, db_in))


def test_function_derivatives_match_jax():
    """The Function's forward, vjp and the vjp's vjp in dy against JAX's
    op in float32."""
    x, b = _inputs((2, 4, 4, 8), torch.float32, seed=3)
    gen = torch.Generator().manual_seed(4)
    dy = torch.randn(x.shape, generator=gen)
    h = torch.randn(x.shape, generator=gen)
    k = torch.randn(8, generator=gen)

    def jax_first(gx):
        _, vjp = jax.vjp(jax_fused_leaky_relu, jnp.asarray(x.numpy()),
                         jnp.asarray(b.numpy()))
        return vjp(gx)

    want_out = np.asarray(jax_fused_leaky_relu(jnp.asarray(x.numpy()),
                                               jnp.asarray(b.numpy())))
    want_dx, want_db = jax_first(jnp.asarray(dy.numpy()))
    want_g2 = jax.grad(lambda gx: jnp.sum(jax_first(gx)[0] * h.numpy())
                       + jnp.sum(jax_first(gx)[1] * k.numpy()))(
        jnp.asarray(dy.numpy()))

    xx, bb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    gg = dy.clone().requires_grad_(True)
    out = function(xx, bb)
    dx, db = torch.autograd.grad(out, (xx, bb), gg, create_graph=True)
    (g2,) = torch.autograd.grad((dx * h).sum() + (db * k).sum(), gg)
    for got, want in ((out, want_out), (dx, want_dx), (db, want_db),
                      (g2, want_g2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_r1_through_a_small_network_matches_the_old_expression():
    """An R1 penalty (the squared input gradient of a conv, activation,
    conv, activation, sum) and its gradient in every parameter, float64,
    the Function against the old expression."""
    gen = torch.Generator().manual_seed(5)
    params = [torch.randn(s, generator=gen, dtype=torch.float64) * 0.3
              for s in ((6, 3, 3, 3), (6,), (4, 6, 3, 3), (4,))]
    images = torch.rand((2, 8, 8, 3), generator=gen, dtype=torch.float64)

    def penalty(act):
        ps = [p.clone().requires_grad_(True) for p in params]
        x = images.clone().requires_grad_(True)
        h = x
        for w, b in ((ps[0], ps[1]), (ps[2], ps[3])):
            h = F.conv2d(h.permute(0, 3, 1, 2), w, padding=1).permute(
                0, 2, 3, 1)
            h = act(h.contiguous(), b)
        (gx,) = torch.autograd.grad(h.sum(), x, create_graph=True)
        r1 = gx.pow(2).sum()
        return [r1.detach()] + list(torch.autograd.grad(
            r1, ps, allow_unused=True, materialize_grads=True))

    for got, want in zip(penalty(function), penalty(old_expression)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["float16", "float64", "non_contiguous",
                                  "bias_shape", "bias_2d", "zero_gain"])
def test_kernel_arguments_are_checked(case):
    """What the wrapper refuses on a CUDA tensor before any launch
    (``check``, which reads no device)."""
    x = torch.zeros(2, 4, 4, 8)
    fused_act.check(x, torch.zeros(8), GAIN)  # what the kernel takes
    bias, scale, error = torch.zeros(8), GAIN, ValueError
    if case in ("float16", "float64"):
        x, error = x.to(getattr(torch, case)), TypeError
    elif case == "non_contiguous":  # every second channel
        x = torch.zeros(2, 4, 4, 16)[..., ::2]
    elif case == "bias_shape":
        bias = torch.zeros(4)
    elif case == "bias_2d":
        bias = torch.zeros(1, 8)
    else:
        scale = 0.0
    with pytest.raises(error):
        fused_act.check(x, bias, scale)


def test_other_devices_are_refused_and_cpu_launches_nothing():
    before = (fused_act.fused_leaky_relu.launches,
              fused_act.fused_leaky_relu.scalar_launches)
    with pytest.raises(RuntimeError):
        fused_act.fused_leaky_relu(torch.zeros(2, 8, device="meta"),
                                   torch.zeros(8, device="meta"))
    x = torch.randn(2, 8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    fused_act.fused_leaky_relu(x, b).sum().backward()
    function(x, b).sum().backward()
    assert (fused_act.fused_leaky_relu.launches,
            fused_act.fused_leaky_relu.scalar_launches) == before


def _main_path_shapes(size=512, batch=16, d_batch=48):
    """Every tensor the 512x512 recipe activates: D's at the D phase's
    batch (two views and the fakes) and G's, with the style MLP's."""
    ch = stylegan2_channels(1.0)
    shapes = [(d_batch, size, size, ch[size])]  # from_rgb
    res = size
    while res > 4:
        shapes += [(d_batch, res, res, ch[res]),  # ResBlock conv1
                   (d_batch, res // 2, res // 2, ch[res // 2])]  # conv2
        res //= 2
    shapes += [(d_batch, 4, 4, ch[4]), (batch, 512), (batch, 4, 4, ch[4])]
    res = 8
    while res <= size:
        shapes += [(batch, res, res, ch[res])] * 2  # two StyleLayers
        res *= 2
    return shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_of_the_main_path(dtype):
    """Every activated tensor of the 512x512 recipe takes the 16-byte path
    in either memory layout; blocks hold whole rows of packs or one
    channel's packs, at most 256 threads; the grid is about one wave at
    most and a small tensor takes few blocks."""
    waves = fused_act._GRID_BLOCKS
    for shape in _main_path_shapes():
        rows, c = math.prod(shape[:-1]), shape[-1]
        big = rows * c * dtype.itemsize >= 32 * 2**20
        for mode, partials in ((fused_act.ACT, False),
                               (fused_act.GRAD, True)):
            p = fused_act.launch_plan(rows, c, 1, dtype, mode, True,
                                      partials)
            assert p.vector == 1 and p.planes == 0
            assert p.packs * 16 == c * dtype.itemsize
            assert p.threads == p.cw * p.ry <= 256 and p.gy == 1
            assert p.cw == p.packs  # a block's threads span whole rows
            chunks = math.ceil(rows / p.ry)
            assert p.gx == min(math.ceil(chunks / fused_act._UNROLL), waves)
            assert p.gx == waves or not big, shape
            if len(shape) == 2:
                continue
            n, inner = shape[0], rows // shape[0]
            q = fused_act.launch_plan(n, c, inner, dtype, mode, True,
                                      partials)
            assert q.vector == 1 and q.planes == 1 and q.gy == c
            assert q.packs * 16 == inner * dtype.itemsize
            total = n * q.packs
            assert 32 <= q.threads <= 256 and q.threads % 32 == 0
            assert q.threads * fused_act._UNROLL >= min(total, 1024)
            assert 1 <= q.gx <= math.ceil(waves / c)
            assert q.gx * c <= waves + c
            assert q.gx == math.ceil(waves / c) or not big, shape
    mlp = fused_act.launch_plan(16, 512, 1, dtype, fused_act.ACT, True,
                                False)
    assert mlp.gx == {torch.float32: 2, torch.bfloat16: 1}[dtype]


@pytest.mark.parametrize("c,dtype,aligned,vector", [
    (37, torch.float32, True, 0),  # C * 4 not a multiple of 16
    (12, torch.bfloat16, True, 0),  # C * 2 not a multiple of 16
    (32, torch.float32, False, 0),  # data not 16-byte aligned
    (3, torch.float32, True, 0),
    (4, torch.float32, True, 1),
    (1536, torch.float32, True, 1),  # 384 packs: two blocks across a row
])
def test_launch_plan_paths_on_rows(c, dtype, aligned, vector):
    p = fused_act.launch_plan(1000, c, 1, dtype, fused_act.GRAD, False,
                              True, aligned)
    assert p.vector == vector and p.planes == 0
    assert p.packs == (c * dtype.itemsize // 16 if vector else c)
    assert p.gy == math.ceil(p.packs / 256) and p.cw * p.gy >= p.packs
    assert p.threads == p.cw * p.ry <= 256 and p.ry == 256 // p.cw
    with pytest.raises(ValueError):
        fused_act.launch_plan(1000, c, 1, dtype, fused_act.ACT, False, True)
    with pytest.raises(ValueError):
        fused_act.launch_plan(2**31, c, 1, dtype, fused_act.ACT, False,
                              False)


@pytest.mark.parametrize("inner,dtype,aligned,vector", [
    (9, torch.float32, True, 0),  # 3x3 planes: 36 bytes
    (4, torch.bfloat16, True, 0),  # 8 bytes
    (64, torch.float32, False, 0),  # data not 16-byte aligned
    (16, torch.float32, True, 1),
    (16, torch.bfloat16, True, 1),
    (262144, torch.float32, True, 1),  # a 512x512 plane
])
def test_launch_plan_paths_on_planes(inner, dtype, aligned, vector):
    p = fused_act.launch_plan(48, 32, inner, dtype, fused_act.GRAD, True,
                              True, aligned)
    assert p.vector == vector and p.planes == 1 and p.gy == 32
    assert p.packs == (inner * dtype.itemsize // 16 if vector else inner)
    assert p.threads % 32 == 0 and 32 <= p.threads <= 256
    assert p.gx * p.threads * fused_act._UNROLL >= min(
        48 * p.packs, fused_act._GRID_BLOCKS // 32 * 1024)
    with pytest.raises(ValueError):  # 2**31 packs of a channel
        fused_act.launch_plan(2**31 // inner + 1, 32, inner, dtype,
                              fused_act.ACT, False, False, False)


@pytest.mark.parametrize("to_planes", [True, False])
def test_launch_plan_transposing(to_planes):
    """A gradient in the other layout than the output's: 32 x 32 tiles of
    one image's channels and pixels, 256 threads, a channel tile a grid
    row, at most a wave of blocks."""
    p = fused_act.launch_plan(48, 40, 512 * 512, torch.float32,
                              fused_act.GRAD, True, True, False, 0, to_planes)
    assert (p.transpose, p.planes, p.vector) == (1, int(to_planes), 0)
    assert (p.threads, p.gy, p.rows, p.inner) == (256, 2, 48, 512 * 512)
    assert p.gx == math.ceil(fused_act._GRID_BLOCKS / 2)
    small = fused_act.launch_plan(2, 8, 9, torch.bfloat16, fused_act.GRAD,
                                  False, False, True, 0, to_planes)
    assert (small.gx, small.gy) == (2, 1)  # an image's one tile each
    with pytest.raises(ValueError):
        fused_act.launch_plan(2, 8, 9, torch.float32, fused_act.ACT, False,
                              False, True, 0, to_planes)


def test_layouts():
    """Channels innermost, channel planes (NCHW memory), neither; the
    output keeps the input's layout; a gradient in another layout than the
    forward's output is copied into it."""
    x = torch.randn(2, 4, 3, 8)
    planes = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert fused_act._layout(x) == (24, 8, 1)
    assert fused_act._layout(planes) == (2, 8, 12)
    assert fused_act._layout(torch.randn(5, 8)) == (5, 8, 1)
    assert fused_act._layout(x[:, :, ::2]) is None
    assert fused_act._layout(torch.zeros(0, 8)) == (0, 8, 1)
    b = torch.randn(8)
    out = function(planes, b)
    assert out.stride() == planes.stride()
    assert torch.equal(out, old_expression(x, b))
    y, db = fused_act._grad(x, None, out, 0.2, GAIN, True)
    want, want_db = fused_act._grad(planes, None, out, 0.2, GAIN, True)
    assert y.stride() == out.stride() and torch.equal(y, want)
    assert torch.equal(db, want_db)


class _StandIn:
    """A stand-in for the built library: records each call's plan and
    which pointers were null."""

    def __init__(self):
        self.calls = []

    def fused_act_nhwc(self, inp, ref, bias, out, partial, db, plan, slope,
                       gain, stream):
        p = plan._obj
        self.calls.append(dict(
            {name: getattr(p, name) for name, _ in p._fields_},
            null=[a is None for a in (inp, ref, bias, out, partial, db)],
            slope=slope, gain=gain))
        return 0


def test_launch_counts_and_arguments(monkeypatch):
    """The host side of a launch without a card: each mode's counts (a
    forward 1, a gradient with its bias sum 2, without it 1, the scalar path
    counted apart), the plan and the pointers handed to the library, the
    partial rows allocated to the plan's grid; and the graph runner advances
    this counter at each replay, as the blur's."""
    lib = _StandIn()
    monkeypatch.setattr(fused_act, "_library", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    counter = fused_act.fused_leaky_relu
    monkeypatch.setattr(counter, "launches", 0)
    monkeypatch.setattr(counter, "scalar_launches", 0)
    x = torch.zeros(64, 32)
    b = torch.zeros(32)
    fused_act._launch(fused_act.ACT, x, b, None, 0.2, GAIN, False)
    _, db = fused_act._launch(fused_act.GRAD, x, None, x, 0.2, GAIN, True)
    assert db.shape == (32,)
    fused_act._launch(fused_act.GRAD, x, b, x, 0.2, GAIN, False)
    fused_act._launch(fused_act.ACT, torch.zeros(8, 5), None, None, 0.2,
                      GAIN, False)
    planes = torch.zeros(2, 32, 4, 4).permute(0, 2, 3, 1)
    out, _ = fused_act._launch(fused_act.ACT, planes, b, None, 0.2, GAIN,
                               False)
    assert out.stride() == planes.stride()
    # a gradient channels innermost for an output in channel planes
    y, _ = fused_act._launch(fused_act.GRAD, planes.contiguous(), None,
                             planes, 0.2, GAIN, True)
    assert y.stride() == planes.stride()
    assert (counter.launches, counter.scalar_launches) == (8, 1)
    act, grad, grad_b, odd, plane, mixed = lib.calls
    assert (mixed["transpose"], mixed["planes"], mixed["rows"],
            mixed["inner"], mixed["gy"]) == (1, 1, 2, 16, 1)
    assert (plane["planes"], plane["rows"], plane["c"], plane["inner"],
            plane["vector"]) == (1, 2, 32, 16, 1)
    assert (act["planes"], act["inner"], act["rows"]) == (0, 1, 64)
    assert act["null"] == [False, True, False, False, True, True]
    assert grad["null"] == [False, False, True, False, False, False]
    assert grad_b["null"] == [False, False, False, False, True, True]
    assert (act["mode"], grad["mode"], grad["partials"],
            grad_b["has_bias"]) == (0, 1, 1, 1)
    assert (odd["vector"], odd["c"], odd["rows"]) == (0, 5, 8)
    assert act["gain"] == pytest.approx(GAIN) and act["slope"] == 0.2
    assert graph.COUNTED == (blur.blur2d, counter,
                             filtered_lrelu.filtered_lrelu)
