"""The port's blur (``contrad_tpu_torch/ops/blur.py``) against the JAX
package: the XLA composite ``ops/upfirdn2d.py::blur2d`` and the Pallas kernel
``ops/pallas_blur.py::pallas_blur2d`` (interpret mode, as
``tests/test_stylegan2.py`` runs it). On the CPU the port runs its plain
version; the CUDA kernel is held to that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``.

Tolerances: f32 sums of 16 products of O(1) values in another order differ
by a few ulps, so rtol 1e-5 / atol 1e-5 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.ops.upfirdn2d import blur2d as jax_blur2d
from contrad_tpu.ops.upfirdn2d import make_kernel as jax_make_kernel
from contrad_tpu_torch.ops import blur as port_blur
from contrad_tpu_torch.ops.upfirdn2d import blur2d as port_blur2d
from contrad_tpu_torch.ops.upfirdn2d import blur_taps, make_kernel

TOL = dict(rtol=1e-5, atol=1e-5)
# (pad, upsample_factor): D's downsample blurs (3x3 and 1x1 convs), G's
# post-upsample blur, and the adjoint pads their backward uses
CASES = [((2, 2), 1), ((1, 1), 1), ((1, 1), 2), ((0, 3), 1), ((3, 0), 2)]


def _jax_fn(pad, up):
    k = jax_make_kernel([1, 3, 3, 1])
    return lambda x: jax_blur2d(x, k, pad, upsample_factor=up)


def _port(x, pad, up):
    return port_blur2d(x, make_kernel([1, 3, 3, 1]), pad, upsample_factor=up)


@pytest.mark.parametrize("pad,up", CASES)
@pytest.mark.parametrize("c", [128, 5])
def test_blur_forward_matches_jax(pad, up, c):
    x = np.random.default_rng(0).normal(size=(2, 11, 9, c)).astype(np.float32)
    want = np.asarray(_jax_fn(pad, up)(jnp.asarray(x)))
    got = _port(torch.from_numpy(x), pad, up).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pad", [(2, 2), (1, 1)])
def test_blur_matches_pallas_kernel(pad):
    from jax.experimental.pallas import tpu as pltpu

    from contrad_tpu.ops.pallas_blur import pallas_blur2d

    x = np.random.default_rng(1).normal(size=(2, 19, 13, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_blur2d(jnp.asarray(x),
                                        jax_make_kernel([1, 3, 3, 1]), pad,
                                        tile_h=8))
    got = _port(torch.from_numpy(x), pad, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pad,up", CASES[:3])
@pytest.mark.parametrize("c", [128, 5])
def test_blur_first_and_second_derivatives_match_jax(pad, up, c):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 10, c)).astype(np.float32)
    f = _jax_fn(pad, up)
    y_shape = f(jnp.asarray(x)).shape
    g = rng.normal(size=y_shape).astype(np.float32)
    h = rng.normal(size=x.shape).astype(np.float32)

    # first derivative: x -> <blur(x), g>
    want_gx = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * g))(jnp.asarray(x)))
    # second: g -> <blur^T g, h>, the path R1's gradient takes
    want_gg = np.asarray(jax.grad(lambda gg: jnp.sum(
        jax.vjp(f, jnp.asarray(x))[1](gg)[0] * h))(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    (gx,) = torch.autograd.grad(_port(xt, pad, up), xt, grad_outputs=gt,
                                create_graph=True)
    (gg,) = torch.autograd.grad(gx, gt, grad_outputs=torch.from_numpy(h))
    np.testing.assert_allclose(gx.detach().numpy(), want_gx, **TOL)
    np.testing.assert_allclose(gg.numpy(), want_gg, **TOL)


def test_blur_taps_are_the_jax_separation():
    from contrad_tpu.ops.upfirdn2d import _separate

    col, row = _separate(jax_make_kernel([1, 3, 3, 1]) * 4)
    taps_v, taps_h = blur_taps(make_kernel([1, 3, 3, 1]), 2)
    np.testing.assert_array_equal(np.float32(taps_v), col)
    np.testing.assert_array_equal(np.float32(taps_h), row)


@pytest.mark.parametrize("pad", [(-1, 0), (0, 4), (4, 4)])
def test_blur_rejects_pads_outside_the_taps(pad):
    with pytest.raises(ValueError):
        port_blur.blur2d(torch.zeros(1, 4, 4, 2), (1.0,) * 4, (1.0,) * 4, pad)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = port_blur.blur2d.launches
    x = torch.randn(1, 6, 6, 3)
    y = port_blur.blur2d(x, (0.25, 0.75, 0.75, 0.25), (0.25,) * 4, (1, 2))
    torch.testing.assert_close(
        y, port_blur.blur2d_plain(x, (0.25, 0.75, 0.75, 0.25), (0.25,) * 4,
                                  (1, 2)))
    assert port_blur.blur2d.launches == before

