"""StyleGAN3's filtered leaky ReLU (``ops/filtered_lrelu.py``).

On the CPU: the plain op against an unfused upfirdn, activation, upfirdn
(each one depthwise convolution with the 2-D outer product of the 1-D
filter, where the op takes two 1-D passes) in float64: forward, ``dx`` and ``db``, with the clamp engaged and negative
pads, at the schedule's four kinds of layer.

``cuda``-marked (on the card; they skip without one): the hand-written
kernel against that reference at every layer shape of StyleGAN3-T's
512x512 schedule at batch 2, float32 and bfloat16, with its launch counts.
The reference runs in float64 and takes the activation's branches from the
kernel's sign bits, which the test checks against the reference's own
branches wherever those are not within rounding of a kink (a value within
1e-5 of zero or of the clamp flips under any reordering of the sums, and
would move ``dx`` by a whole slope there). Tolerances: float32, sums of up
to 24 products in another order, 1e-5 of the largest magnitude; bfloat16,
the input rounded once and the output once, 1e-2 of it. The file imports
nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_filtered_lrelu.py
"""

import math

import numpy as np
import pytest
import torch

from contrad_tpu_torch.models.stylegan3 import synthesis_schedule
from contrad_tpu_torch.ops import filtered_lrelu as flr

SCHEDULE = synthesis_schedule(512)[1:]


def _filters(spec):
    fu = flr.lowpass_filter(spec["taps_up"], spec["in_cutoff"],
                            2 * spec["in_half_width"], spec["tmp_rate"])
    fd = flr.lowpass_filter(spec["taps_down"], spec["out_cutoff"],
                            2 * spec["out_half_width"], spec["tmp_rate"])
    return (None if fu is None else tuple(fu.tolist()),
            None if fd is None else tuple(fd.tolist()))


def _upfirdn2d(x, f, up=1, down=1, pad=(0, 0)):
    """NCHW upfirdn with the 2-D filter ``f f^T`` in ``x``'s dtype, one
    depthwise convolution: zeros inserted, padded (negative crops),
    correlated, every ``down``-th sample kept."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    x = torch.nn.functional.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    k = torch.as_tensor(np.outer(f, f), dtype=x.dtype, device=x.device)
    return torch.nn.functional.conv2d(x, k.expand(c, 1, *k.shape),
                                      stride=down, groups=c)


def _grid(x, b, fu, up, padding, grid):
    """The upsampled grid, NCHW: upfirdn with the filter fu fu^T up^2, cut
    to the rows and columns the downsampling reads."""
    t = (x + b).permute(0, 3, 1, 2)
    if fu is not None:
        t = _upfirdn2d(t, np.asarray(fu) * up, up=up,
                       pad=(padding[0], padding[1]))
    return t[:, :, :grid[0], :grid[1]]


def _down(a, fd, down):
    if fd is not None:
        a = _upfirdn2d(a, np.asarray(fd), down=down)
    return a.permute(0, 2, 3, 1)


def _unfused(x, b, fu, fd, up, down, padding, gain, slope, clamp, grid):
    u = _grid(x, b, fu, up, padding, grid)
    a = torch.where(u < 0, u * slope, u) * gain
    return _down(torch.clamp(a, -clamp, clamp), fd, down)


# the schedule's four kinds of layer, at widths a CPU takes
CPU_CASES = [(0, 5), (2, 13), (13, 4), (14, 3)]  # (layer, channels)


@pytest.mark.parametrize("layer,c", CPU_CASES)
def test_plain_op_matches_unfused_upfirdn(layer, c):
    spec = SCHEDULE[layer]
    fu, fd = _filters(spec)
    up, down, pad = spec["up"], spec["down"], spec["padding"]
    size = min(spec["in_size"] + spec["kernel"] - 1, 40)
    gen = torch.Generator().manual_seed(layer)
    x = torch.randn(2, size, size, c, generator=gen,
                    dtype=torch.float64).requires_grad_(True)
    b = torch.randn(c, generator=gen, dtype=torch.float64).requires_grad_(True)
    gain, slope, clamp = ((1.0, 1.0, 1.0) if spec["torgb"]
                          else (math.sqrt(2), 0.2, 1.5))  # the clamp engaged
    geo = flr.geometry(size, size, up, down, len(fu or (1,)),
                       len(fd or (1,)), pad)
    y = flr.filtered_lrelu(x, b, fu, fd, up, down, pad, gain, slope, clamp)
    want = _unfused(x, b, fu, fd, up, down, pad, gain, slope, clamp,
                    (geo.grid_h, geo.grid_w))
    assert y.shape == want.shape == (2, geo.h_out, geo.w_out, c)
    assert torch.allclose(y, want, rtol=0, atol=1e-12)
    a = _grid(x, b, fu, up, pad, (geo.grid_h, geo.grid_w)) * gain
    assert (a.abs() > clamp).any() and (a.abs() < clamp).any()
    dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(y, (x, b), dy)
    ref = torch.autograd.grad(want, (x, b), dy)
    for g, r in zip(got, ref):
        assert torch.allclose(g, r, rtol=0, atol=1e-11)


@pytest.mark.parametrize("c", [3, 8, 13])
def test_branches_unpack_the_sign_words(c):
    """Bit k of a group's word is channel k's branch, bit 8 + k its clamp;
    the words of a last, partial group leave their spare bits unread."""
    gen = torch.Generator().manual_seed(c)
    neg = torch.rand(2, c, 5, 4, generator=gen) < 0.5
    clp = torch.rand(2, c, 5, 4, generator=gen) < 0.5
    groups = -(-c // flr.GROUP)
    words = torch.zeros(2, groups, 5, 4, dtype=torch.int32)
    for ch in range(c):
        g, k = divmod(ch, flr.GROUP)
        words[:, g] |= (neg[:, ch].int() << k) | (clp[:, ch].int() << (8 + k))
    words[:, -1] |= 1 << 15  # a spare bit or the last channel's clamp
    got_neg, got_clp = flr.branches(words.to(torch.int16), c)
    assert torch.equal(got_neg, neg)
    if c % flr.GROUP:
        assert torch.equal(got_clp, clp)
    else:
        want = clp.clone()
        want[:, -1] = True
        assert torch.equal(got_clp, want)


def test_geometry_and_filters_of_the_schedule():
    """Every layer's output size follows from its padding, and its filters
    are low-pass: unit DC gain, symmetric."""
    for spec in SCHEDULE:
        fu, fd = _filters(spec)
        side = spec["in_size"] + spec["kernel"] - 1
        geo = flr.geometry(side, side, spec["up"], spec["down"],
                           spec["taps_up"], spec["taps_down"], spec["padding"])
        assert geo.h_out == spec["out_size"]
        for f in (fu, fd):
            if f is not None:
                assert abs(sum(f) - 1) < 1e-6
                assert np.allclose(f, f[::-1], atol=1e-7)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the filtered_lrelu kernel has no CPU "
                    "mode")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", range(len(SCHEDULE)))
def test_kernel_matches_the_reference_at_each_layer(cuda, dtype, layer):
    spec = SCHEDULE[layer]
    fu, fd = _filters(spec)
    up, down, pad = spec["up"], spec["down"], spec["padding"]
    c, side = spec["out_channels"], spec["in_size"] + spec["kernel"] - 1
    gain, slope = (1.0, 1.0) if spec["torgb"] else (math.sqrt(2), 0.2)
    clamp = 2.5  # engaged at unit inputs (the layers' 256 rarely is)
    gen = torch.Generator(device=cuda).manual_seed(layer)
    x = torch.randn(2, side, side, c, generator=gen, device=cuda).to(dtype)
    b = (0.3 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    x.requires_grad_(True)
    b.requires_grad_(True)
    launches = flr.filtered_lrelu.launches
    y = flr.filtered_lrelu(x, b, fu, fd, up, down, pad, gain, slope, clamp)
    assert flr.filtered_lrelu.launches == launches + 1
    (signs,) = y.grad_fn.saved_tensors
    dy = torch.randn(y.shape, generator=gen, device=cuda).to(dtype)
    dx, db = torch.autograd.grad(y, (x, b), dy)
    torch.cuda.synchronize()
    assert flr.filtered_lrelu.launches == launches + 2
    assert flr.filtered_lrelu.scalar_launches == 0
    assert y.dtype == dx.dtype == db.dtype == dtype
    assert y.shape == (2, spec["out_size"], spec["out_size"], c)

    geo = flr.geometry(side, side, up, down, spec["taps_up"],
                       spec["taps_down"], pad)
    grid = (geo.grid_h, geo.grid_w)
    assert tuple(signs.shape) == (2, -(-c // 8)) + grid
    x64, b64 = x.detach().double(), b.detach().double()
    u = _grid(x64, b64, fu, up, pad, grid)
    v = torch.where(u < 0, u * slope, u) * gain
    want = _down(v.clamp(-clamp, clamp), fd, down)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = want.abs().max()
    assert (y.double() - want).abs().max() <= tol * scale

    neg, clp = flr.branches(signs, c)
    eps = 1e-5 * u.abs().max()
    sure = u.abs() > eps
    if slope != 1.0:
        assert torch.equal(neg[sure], (u < 0)[sure])
    far = (v.abs() - clamp).abs() > eps
    assert torch.equal(clp[far], (v.abs() > clamp)[far])
    assert clp.any() and (~clp).any()

    factor = torch.where(clp, 0.0, gain * torch.where(neg, slope, 1.0))
    xr = x64.clone().requires_grad_(True)
    br = b64.clone().requires_grad_(True)
    lin = _down(factor.double() * _grid(xr, br, fu, up, pad, grid), fd, down)
    dx_ref, db_ref = torch.autograd.grad(lin, (xr, br), dy.double())
    assert (dx.double() - dx_ref).abs().max() <= tol * dx_ref.abs().max()
    assert ((db.double() - db_ref).abs().max()
            <= tol * dx_ref.abs().sum((0, 1, 2)).max())


@pytest.mark.cuda
def test_kernel_refuses_what_it_is_not_built_for(cuda):
    x = torch.zeros(1, 20, 20, 8, device=cuda)
    taps = tuple([1 / 8] * 8)
    with pytest.raises(ValueError):  # 8 taps
        flr.filtered_lrelu(x, None, taps, taps, 2, 2, (3, 3, 3, 3))
    with pytest.raises(TypeError):
        flr.filtered_lrelu(x.half(), None, None, None)
