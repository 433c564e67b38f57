"""The port's space-to-depth packed convolutions
(``contrad_tpu_torch/ops/packed.py``) and ``compose_blur_kernel``
(``ops/upfirdn2d.py``) against the JAX package's, case for case as
``tests/test_packed.py`` runs them (every case that needs no model
``pack=`` form).

Held: the packed weights bitwise to JAX's (OIHW against HWIO); each packed
conv to the port's own unpacked conv within 1e-12 in float64; the port's
outputs to JAX's within rtol 1e-4 / atol 1e-6 and gradients within rtol
1e-3 / atol 1e-5, both packages in float64 (float32 convs of a few thousand
terms differ by more than 1e-6 in the order of their sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contrad_tpu.ops import packed as jp
from contrad_tpu.ops.upfirdn2d import compose_blur_kernel as jax_compose
from contrad_tpu.ops.upfirdn2d import upsample2d as jax_upsample2d
from contrad_tpu_torch.ops import packed as pp
from contrad_tpu_torch.ops.upfirdn2d import (
    compose_blur_kernel, make_kernel, upsample2d)
from torch_port_jax import one_torch_thread, t  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
EXACT = dict(rtol=0, atol=1e-12)  # float64, packed against unpacked


def _hwio(w: np.ndarray) -> np.ndarray:
    """OIHW -> JAX's HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _oihw(w) -> np.ndarray:
    return np.asarray(w).transpose(3, 2, 0, 1)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad, l: int = 1):
    """The unpacked NHWC conv with pads (lo, hi) and lhs dilation ``l``
    (zeros between input pixels): F.conv2d on the NCHW view."""
    xc = x.permute(0, 3, 1, 2)
    if l > 1:
        n, c, h, ww = xc.shape
        z = xc.new_zeros(n, c, h, l, ww, l)
        z[:, :, :, 0, :, 0] = xc
        xc = z.reshape(n, c, h * l, ww * l)[:, :, :h * l - l + 1,
                                              :ww * l - l + 1]
    xc = F.pad(xc, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)


def fir(x: torch.Tensor, kernel: np.ndarray, pad) -> torch.Tensor:
    """The 2-D FIR correlation of each channel of an NHWC tensor with
    ``kernel`` after zero pads (lo, hi), in x's dtype (the blur kernel's
    separable taps are float32 factors of the 2-D kernel)."""
    c = x.shape[-1]
    k = torch.tensor(kernel, dtype=x.dtype)[None, None]
    xc = F.pad(x.permute(0, 3, 1, 2), (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(xc, k.expand(c, 1, *kernel.shape),
                    groups=c).permute(0, 2, 3, 1)


def jax_conv(x, w, stride, pad, l=1):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), (pad, pad), lhs_dilation=(l, l),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def test_s2d_roundtrip(np_rng):
    x = np_rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    for f in (2, 4):
        xp = pp.space_to_depth(t(x), f)
        np.testing.assert_array_equal(xp.numpy(),
                                      np.asarray(jp.space_to_depth(x, f)))
        np.testing.assert_array_equal(pp.depth_to_space(xp, f).numpy(), x)
        np.testing.assert_array_equal(
            pp.depth_to_space(xp, f).numpy(),
            np.asarray(jp.depth_to_space(jnp.asarray(xp.numpy()), f)))
    with pytest.raises(ValueError):
        pp.space_to_depth(t(x[:, :7]), 2)


def test_s2d_channel_convention(np_rng):
    """slot index (a_y*f + a_x)*C + c."""
    x = np_rng.normal(size=(1, 4, 4, 3)).astype(np.float32)
    xp = pp.space_to_depth(t(x), 2).numpy()
    for ay in range(2):
        for ax in range(2):
            slot = ay * 2 + ax
            np.testing.assert_array_equal(
                xp[0, :, :, slot * 3:(slot + 1) * 3], x[0, ay::2, ax::2, :])


CASES = [
    # (k, stride, pad, f_in, f_out, ci, co), tests/test_packed.py's
    (1, 1, (0, 0), 2, 2, 3, 32),    # FromRGB
    (3, 1, (1, 1), 2, 2, 32, 32),   # block conv1
    (6, 2, (2, 2), 2, 1, 32, 64),   # blur-fused downsample conv2, unpack out
    (4, 2, (1, 1), 2, 1, 32, 64),   # blur-fused skip, unpack out
    (6, 2, (2, 2), 2, 2, 32, 64),   # conv2 packed-to-packed
    (4, 2, (1, 1), 2, 2, 32, 64),   # skip packed-to-packed
    (3, 1, (1, 1), 4, 4, 3, 16),    # f=4 packing
    (2, 2, (0, 0), 2, 1, 8, 8),     # 2x2 s2 unpack boundary
]


def _check_packed(x, w, stride, pad, f_in, f_out, l=1):
    """Port packed == port unpacked (float64, 1e-12); packed weights
    bitwise JAX's; the port's float32 packed output within TOL of JAX's."""
    x64, w64 = torch.from_numpy(x), torch.from_numpy(w)
    ref = conv(x64, w64, stride, pad, l)
    xin = pp.space_to_depth(x64, f_in)
    got = pp.depth_to_space(
        pp.packed_conv(xin, w64, f_in, f_out, stride, pad, l), f_out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **EXACT)

    wp, S, P = pp.pack_conv_kernel(w64, f_in, f_out, stride, pad, l)
    with jax.enable_x64(True):
        jwp, jS, jP = jp.pack_conv_kernel(jnp.asarray(_hwio(w)), f_in,
                                          f_out, stride, pad, l)
        want = jp.packed_conv(jp.space_to_depth(jnp.asarray(x), f_in),
                              jnp.asarray(_hwio(w)), f_in, f_out, stride,
                              pad, l)
    assert (S, P) == (jS, jP)
    assert wp.dtype == torch.float64 and jwp.dtype == jnp.float64
    np.testing.assert_array_equal(wp.numpy(), _oihw(jwp))
    got = pp.packed_conv(xin, w64, f_in, f_out, stride, pad, l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,stride,pad,f_in,f_out,ci,co", CASES)
def test_packed_conv_parity(np_rng, k, stride, pad, f_in, f_out, ci, co):
    x = np_rng.normal(size=(2, 16, 16, ci))
    w = np_rng.normal(size=(co, ci, k, k)) * 0.1
    _check_packed(x, w, stride, pad, f_in, f_out)


def test_packed_conv_asymmetric_pad(np_rng):
    """The blur-composed convs use (ceil, floor) pads; exercise (2, 1)."""
    x = np_rng.normal(size=(1, 12, 12, 4))
    w = np_rng.normal(size=(8, 4, 5, 5)) * 0.1
    _check_packed(x, w, 2, (2, 1), 2, 2)


def test_pack_kernel_geometry():
    """The derived (S, K, P) of the stem cases, as JAX's test spots them."""
    _, S, (plo, phi) = pp.pack_conv_kernel(torch.zeros(2, 2, 3, 3), 2, 2, 1,
                                           (1, 1))
    assert (S, plo, phi) == (1, 1, 1)  # K=3
    _, S, (plo, phi) = pp.pack_conv_kernel(torch.zeros(2, 2, 6, 6), 2, 1, 2,
                                           (2, 2))
    assert (S, plo) == (1, 1)
    wp, S, (plo, phi) = pp.pack_conv_kernel(torch.zeros(2, 2, 1, 1), 2, 2, 1,
                                            (0, 0))
    assert wp.shape == (8, 8, 1, 1) and S == 1 and plo == 0 and phi == 0
    with pytest.raises(ValueError):
        pp.pack_conv_kernel(torch.zeros(2, 2, 3, 3), 2, 1, 1, (1, 1))
    for args in [(3, 2, 2, 1, 1), (6, 2, 1, 2, 2), (6, 1, 2, 1, 3, 2)]:
        assert pp._axis_geometry(*args) == jp._axis_geometry(*args)


def test_packed_conv_gradients(np_rng):
    """Weight gradients: packed equal to plain in the port (float64), and
    the port's to JAX's."""
    x = np_rng.normal(size=(2, 8, 8, 3))
    w = np_rng.normal(size=(4, 3, 3, 3)) * 0.1

    def port_grads(dtype):
        out = []
        for packed in (False, True):
            wt = torch.tensor(w, dtype=dtype, requires_grad=True)
            xt = torch.tensor(x, dtype=dtype)
            if packed:
                y = pp.depth_to_space(pp.packed_conv(
                    pp.space_to_depth(xt, 2), wt, 2, 2, 1, (1, 1)), 2)
            else:
                y = conv(xt, wt, 1, (1, 1))
            (g,) = torch.autograd.grad(torch.sin(y).sum(), wt)
            out.append(g.numpy())
        return out

    plain, packed = port_grads(torch.float64)
    np.testing.assert_allclose(packed, plain, **EXACT)

    def jax_loss(wj):
        y = jp.packed_conv(jp.space_to_depth(jnp.asarray(x), 2), wj, 2, 2,
                           1, (1, 1))
        return jnp.sum(jnp.sin(jp.depth_to_space(y, 2)))

    with jax.enable_x64(True):
        want = jax.grad(jax_loss)(jnp.asarray(_hwio(w)))
    np.testing.assert_allclose(packed, _oihw(want), **GRAD_TOL)


@pytest.mark.parametrize("k,pad,l,f_out,ci,co", [
    (6, (3, 3), 2, 2, 8, 4),   # G fused upsample conv (blur-composed 6x6)
    (4, (3, 1), 2, 2, 3, 3),   # upfirdn-style asymmetric (even output)
    (3, (1, 1), 1, 1, 4, 4),   # degenerate: l=1 f=1 reduces to plain conv
])
def test_packed_lhs_dilated_parity(np_rng, k, pad, l, f_out, ci, co):
    """lhs-dilated (transpose-conv upsample) convs become dilation-free
    convs in the packed domain: the sub-pixel-convolution identity."""
    x = np_rng.normal(size=(2, 8, 8, ci))
    w = np_rng.normal(size=(co, ci, k, k)) * 0.1
    _check_packed(x, w, 1, pad, 1, f_out, l)
    with jax.enable_x64(True):
        want = jax_conv(jnp.asarray(x), jnp.asarray(_hwio(w)), 1, pad, l)
    got = conv(torch.from_numpy(x), torch.from_numpy(w), 1, pad, l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_subpixel_conv_is_the_ports_upsampling_conv(np_rng):
    """G's upsampling conv as the port runs it (transposed conv with the
    flipped kernel, then the x4 blur with pads (1, 1)) equals the packed
    sub-pixel conv of the blur-folded kernel (``lhs_dilation = 2``, pads
    (3, 3)) that ``chip_smoke.py`` phase 14 sets against it."""
    x = torch.from_numpy(np_rng.normal(size=(2, 8, 8, 6)))
    w = torch.from_numpy(np_rng.normal(size=(4, 6, 3, 3)))
    kern = make_kernel([1, 3, 3, 1])
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           w.transpose(0, 1).flip(2, 3), stride=2)
    ref = fir(y.permute(0, 2, 3, 1), kern * 4, (1, 1))
    kc = compose_blur_kernel(kern * 4, w)
    got = pp.packed_conv(x, kc, 1, 2, 1, (3, 3), lhs_dilation=2)
    assert got.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(pp.depth_to_space(got, 2).numpy(),
                               ref.numpy(), **EXACT)


@pytest.mark.parametrize("kb,k", [(4, 3), (4, 1), (3, 3)])
def test_compose_blur_kernel_matches_jax(np_rng, kb, k):
    """Held to JAX's; and conv_2(blur(x), w) == conv_2(x, K) in the port,
    the downsampling conv folded (float64)."""
    blur = make_kernel(list(np_rng.uniform(0.5, 2.0, size=kb)))
    w = np_rng.normal(size=(5, 3, k, k))
    got = compose_blur_kernel(blur, torch.from_numpy(w))
    with jax.enable_x64(True):
        want = jax_compose(blur, jnp.asarray(_hwio(w)))
    assert got.shape == (5, 3, k + kb - 1, k + kb - 1)
    np.testing.assert_allclose(got.numpy(), _oihw(want), **TOL)

    x = torch.from_numpy(np_rng.normal(size=(2, 12, 12, 3)))
    p = (kb - 2) + (k - 1)
    pad = ((p + 1) // 2, p // 2)
    ref = conv(fir(x, blur, pad), torch.from_numpy(w), 2, (0, 0))
    got = conv(x, compose_blur_kernel(blur, torch.from_numpy(w)), 2, pad)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **EXACT)


@pytest.mark.parametrize("h,c,f,k1", [
    (16, 3, 2, (1, 3, 3, 1)),   # the RGB skip upsample (Toeplitz path)
    (8, 5, 2, (1, 2, 1)),       # odd kernel
    (8, 3, 4, (1, 3, 3, 1)),    # f=4
])
def test_upsample2d_packed_matches_unpacked(np_rng, h, c, f, k1):
    """upsample2d_packed == space_to_depth(upsample2d(...)) with its
    gradient, in the port (float64) and against JAX's (float32)."""
    kern = make_kernel(list(k1))
    x = np_rng.normal(size=(2, h, h, c))

    def port(packed, dtype):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        y = (pp.upsample2d_packed(xt, kern, f) if packed
             else pp.space_to_depth(upsample2d(xt, kern, f), f))
        (g,) = torch.autograd.grad(torch.sin(y).sum(), xt)
        return y.detach().numpy(), g.numpy()

    (y_ref, g_ref), (y, g) = port(False, torch.float64), port(True,
                                                              torch.float64)
    np.testing.assert_allclose(y, y_ref, **EXACT)
    np.testing.assert_allclose(g, g_ref, **EXACT)

    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        want = jp.upsample2d_packed(xj, kern, f)
        g_want = jax.grad(
            lambda a: jnp.sum(jnp.sin(jp.upsample2d_packed(a, kern, f))))(xj)
    np.testing.assert_allclose(y, np.asarray(want), **TOL)
    np.testing.assert_allclose(g, np.asarray(g_want), **GRAD_TOL)


def test_upsample2d_packed_nonseparable_fallback(np_rng):
    """Non-separable kernels take the packed dense-diagonal conv."""
    kern = np.asarray(np_rng.uniform(0.1, 1.0, size=(4, 4)), np.float32)
    kern = kern / kern.sum()
    x = np_rng.normal(size=(2, 8, 8, 3))
    ref = pp.space_to_depth(upsample2d(torch.from_numpy(x), kern, 2), 2)
    got = pp.upsample2d_packed(torch.from_numpy(x), kern, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **EXACT)
    with jax.enable_x64(True):
        want = jp.upsample2d_packed(jnp.asarray(x), kern, 2)
        want_unpacked = jax_upsample2d(jnp.asarray(x),
                                       jnp.asarray(kern, jnp.float64), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jp.space_to_depth(want_unpacked, 2)), **TOL)
