"""The port's augmentations (``contrad_tpu_torch/augment``,
``contrad_tpu_torch/ops/resample.py``) against the JAX package: the port's
``apply`` is given the parameters the JAX key yields (reproduced by
``tests/torch_port_jax.py``) and must give JAX's images and, through the
straight-through HSV adjustment, JAX's gradients.

Tolerance: rtol 1e-5 / atol 1e-5 (f32 elementwise math and 2-tap sums); the
HSV round trip goes through atan2 and a floor-mod, whose last-ulp
differences between XLA and PyTorch reach ~1e-5, so it takes atol 3e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu_torch.augment import AugRng, get_augment
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    jax_flip_params, jax_jitter_params, jax_rrc_params, jax_simclr_params,
    one_torch_thread, t)

TOL = dict(rtol=1e-5, atol=1e-5)
HSV_TOL = dict(rtol=1e-5, atol=3e-5)


def _images(n=6, h=16, w=16, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_resize_crop_matches_jax(seed):
    from contrad_tpu.augment.spatial import random_resize_crop
    from contrad_tpu_torch.augment import RandomResizeCrop

    x = _images(h=16, w=12, seed=seed)
    key = jax.random.PRNGKey(seed)
    want = random_resize_crop()(key, jnp.asarray(x))
    got = RandomResizeCrop().apply(t(x), jax_rrc_params(key, 6, 16, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_horizontal_flip_matches_jax():
    x = _images()
    key = jax.random.PRNGKey(3)
    want = jax_get_augment("hflip")(key, jnp.asarray(x))
    got = get_augment("hflip").apply(t(x), jax_flip_params(key, 6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_color_jitter_matches_jax(seed):
    from contrad_tpu.augment.color import color_jitter
    from contrad_tpu_torch.augment import ColorJitter

    x = _images(seed=seed)
    key = jax.random.PRNGKey(seed)
    want = color_jitter()(key, jnp.asarray(x))
    got = ColorJitter().apply(t(x), jax_jitter_params(key, 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HSV_TOL)


def test_hsv_round_trip_matches_jax():
    from contrad_tpu.augment.color import hsv2rgb as j_hsv2rgb
    from contrad_tpu.augment.color import rgb2hsv as j_rgb2hsv
    from contrad_tpu_torch.augment.color import hsv2rgb, rgb2hsv

    x = _images(seed=8)
    x[0, 0, 0] = 0.0  # black pixel: 0/0 saturation is masked to 0
    x[0, 0, 1] = 0.5  # gray pixel: atan2(0, 0) hue
    np.testing.assert_allclose(rgb2hsv(t(x)).numpy(),
                               np.asarray(j_rgb2hsv(jnp.asarray(x))), **HSV_TOL)
    hsv = np.asarray(j_rgb2hsv(jnp.asarray(x)))
    np.testing.assert_allclose(hsv2rgb(t(hsv)).numpy(),
                               np.asarray(j_hsv2rgb(jnp.asarray(hsv))), **TOL)


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_simclr_chain_and_its_gradient_match_jax(seed):
    x = _images(n=8, seed=seed)
    w = np.random.default_rng(seed + 100).normal(size=x.shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    aug = jax_get_augment("simclr")
    want, vjp = jax.vjp(lambda a: aug(key, a), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(w))

    port = get_augment("simclr")
    xt = t(x).requires_grad_(True)
    got = port.apply(xt, jax_simclr_params(key, 8, 16, 16))
    (got_grad,) = torch.autograd.grad(got, xt, grad_outputs=t(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **HSV_TOL)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               **HSV_TOL)


def test_hsv_backward_is_straight_through():
    from contrad_tpu_torch.augment.color import _HSVAdjust

    x = torch.rand(2, 4, 4, 3, requires_grad=True)
    f = [torch.rand(2, 1, 1) for _ in range(3)]
    g = torch.randn(2, 4, 4, 3)
    (gx,) = torch.autograd.grad(_HSVAdjust.apply(x, *f), x, grad_outputs=g)
    torch.testing.assert_close(gx, g, rtol=0, atol=0)


def test_sampled_params_are_in_range_and_reproducible():
    port = get_augment("simclr")
    shape = (64, 32, 32, 3)
    p1 = port.sample(shape, AugRng.from_seed(7, torch.device("cpu")))
    p2 = port.sample(shape, AugRng.from_seed(7, torch.device("cpu")))
    rrc, flip, jitter, gray = p1
    assert bool(((rrc["sx"] > 0) & (rrc["sx"] <= 1)).all())
    assert bool((rrc["bx"].abs() <= 1 - rrc["sx"] + 1e-6).all())
    assert bool(((jitter["inner"]["f_h"].abs() <= 0.1)).all())
    assert 0 < int(flip["flip"].sum()) < 64
    x = torch.rand(shape)
    torch.testing.assert_close(port.apply(x, p1), port.apply(x, p2),
                               rtol=0, atol=0)
