"""The augment modes of the 512x512 recipe and the rest of the JAX
registry (``contrad_tpu_torch/augment``, ``ops/resample.py``) against the
JAX package: the port's ``apply`` is given the parameters the JAX key
yields (reproduced by ``tests/torch_port_jax.py``) and must give JAX's
images and, where the op is differentiable, JAX's gradients.

Tolerances: integer and index draws, and ops that only move, mask or zero
pixels (nearest warps, cutouts, translations), exact; sums and elementwise
math (Gaussian noise and blur, diffaug's colour ops) rtol 1e-4 / atol 1e-6;
whole chains with the HSV jitter rtol 1e-5 / atol 3e-5, the HSV round
trip's tolerance (``tests/test_torch_port_augment.py`` says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.augment.spatial import cutout as jax_cutout
from contrad_tpu.augment.spatial import random_crop as jax_random_crop
from contrad_tpu.ops.resample import axis_aligned_transform as jax_warp
from contrad_tpu_torch.augment import (
    CutOut, GaussianBlur, RandomCrop, get_augment)
from contrad_tpu_torch.ops.resample import axis_aligned_transform
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    jax_blur_params, jax_cutout_params, jax_diffaug_params, jax_hfrt_params,
    jax_noise_params, jax_random_crop_params, jax_simclr_params,
    one_torch_thread, t)

TOL = dict(rtol=1e-4, atol=1e-6)
HSV_TOL = dict(rtol=1e-5, atol=3e-5)
# the 512x512 recipe's [augment] table (afhq_dog_style64.toml), cut to what
# the chains read
HQ = {"rrc": {"scale": (0.08, 1.0)},
      "color_jitter": {"brightness": 0.8, "contrast": 0.8, "saturation": 0.8,
                       "hue": 0.2},
      "cutout": {"length": 5}}
JAX_MODES = ("none", "gaussian", "hflip", "hfrt", "color_jitter", "cutout",
             "simclr", "simclr_hq", "simclr_hq_cutout", "diffaug")


def _images(n=4, h=16, w=16, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, h, w, 3)).astype(
        np.float32)


def _with_grad(jax_fn, port_fn, x, seed):
    """(images, input gradient) of JAX's ``jax_fn`` and the port's
    ``port_fn`` for a random output cotangent."""
    w = np.random.default_rng(seed + 100).normal(size=x.shape).astype(
        np.float32)
    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(w))
    xt = t(x).requires_grad_(True)
    got = port_fn(xt)
    (got_grad,) = torch.autograd.grad(got, xt, grad_outputs=t(w))
    return (got.detach().numpy(), np.asarray(want), got_grad.numpy(),
            np.asarray(want_grad))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_warp_matches_jax_in_every_mode(mode, padding_mode):
    rng = np.random.default_rng(1)
    x = _images(n=6, h=12, w=10)
    # scales, mirrors and shifts past the border, and exact half-pixel
    # positions (an integer shift over W / 2 lands there for nearest)
    sx = np.array([1.0, -1.0, 0.5, 1.3, 1.0, -0.7], np.float32)
    sy = np.array([1.0, 1.0, 0.8, 0.6, 1.0, 1.2], np.float32)
    bx = np.concatenate([np.array([0.1, -0.4], np.float32),
                         rng.uniform(-1, 1, 3).astype(np.float32),
                         np.array([3 / 5], np.float32)])
    by = rng.uniform(-1, 1, 6).astype(np.float32)
    want = jax_warp(jnp.asarray(x), *(jnp.asarray(a) for a in (sx, sy, bx, by)),
                    mode=mode, padding_mode=padding_mode)
    got = axis_aligned_transform(t(x), t(sx), t(sy), t(bx), t(by), mode=mode,
                                 padding_mode=padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_warp_rejects_unknown_modes():
    x, one = torch.zeros(1, 4, 4, 3), torch.ones(1)
    with pytest.raises(ValueError, match="padding_mode"):
        axis_aligned_transform(x, one, one, one, one, padding_mode="wrap")
    with pytest.raises(ValueError, match="mode"):
        axis_aligned_transform(x, one, one, one, one, mode="bicubic")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("padding_mode", ["reflection", "zeros"])
def test_hfrt_matches_jax(seed, padding_mode):
    x = _images(n=8, h=16, w=12, seed=seed)
    key = jax.random.PRNGKey(seed)
    hyper = {"hfrt": {"max_pixels": 5, "padding_mode": padding_mode}}
    got, want, g_got, g_want = _with_grad(
        lambda a: jax_get_augment("hfrt", hyper)(key, a),
        lambda a: get_augment("hfrt", hyper).apply(
            a, jax_hfrt_params(key, 8, 5)), x, seed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g_got, g_want)


def test_random_crop_matches_jax():
    x = _images(n=8, h=16, w=16, seed=3)
    key = jax.random.PRNGKey(3)
    want = jax_random_crop(4)(key, jnp.asarray(x))
    got = RandomCrop(4).apply(t(x), jax_random_crop_params(key, 8, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [1, 5, 15])
def test_cutout_matches_jax(length):
    x = _images(n=8, h=16, w=12, seed=length)
    key = jax.random.PRNGKey(length)
    got, want, g_got, g_want = _with_grad(
        lambda a: jax_cutout(length)(key, a),
        lambda a: CutOut(length).apply(a, jax_cutout_params(key, 8, 16, 12)),
        x, length)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g_got, g_want)


@pytest.mark.parametrize("length", [0, 4, 16])
def test_cutout_rejects_even_lengths(length):
    with pytest.raises(ValueError, match="odd"):
        CutOut(length)
    with pytest.raises(ValueError, match="odd"):
        get_augment("cutout", {"cutout": {"length": length}})


def test_gaussian_noise_matches_jax():
    x = _images(seed=4)
    key = jax.random.PRNGKey(4)
    want = jax_get_augment("gaussian")(key, jnp.asarray(x))
    got = get_augment("gaussian").apply(t(x), jax_noise_params(key, x.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w,ksize", [(16, 16, 1), (20, 20, 3), (64, 64, 7),
                                       (20, 36, 3), (64, 24, 7)])
def test_gaussian_blur_matches_jax(h, w, ksize):
    from contrad_tpu.augment.color import gaussian_blur

    assert ((h // 10) | 1) == ksize
    x = _images(n=3, h=h, w=w, seed=h + w)
    key = jax.random.PRNGKey(h * w)
    got, want, g_got, g_want = _with_grad(
        lambda a: gaussian_blur()(key, a),
        lambda a: GaussianBlur().apply(a, jax_blur_params(key)), x, h)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(g_got, g_want, **TOL)


def test_gaussian_blur_toeplitz_reflects_without_repeating_the_edge():
    # 51 taps at 512x512, the recipe's size: each row of T sums to 1 and
    # equals the filter applied to jnp.pad(..., mode="reflect")
    sigma = torch.tensor(1.7)
    T = GaussianBlur.toeplitz(sigma, 512, 25)
    np.testing.assert_allclose(T.sum(dim=1).numpy(), 1.0, rtol=1e-6)
    kern = T[100, 75:126].numpy()  # an interior row: the taps themselves
    x = np.random.default_rng(0).normal(size=512)
    want = np.convolve(np.pad(x, 25, mode="reflect"), kern[::-1], "valid")
    np.testing.assert_allclose((T.double() @ torch.from_numpy(x)).numpy(),
                               want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", ["color", "translation", "cutout",
                                    "color,translation,cutout", ""])
def test_diffaug_matches_jax(policy):
    x = _images(n=6, h=16, w=12, seed=7)
    key = jax.random.PRNGKey(len(policy))
    hyper = {"diffaug": {"policy": policy}}
    got, want, g_got, g_want = _with_grad(
        lambda a: jax_get_augment("diffaug", hyper)(key, a),
        lambda a: get_augment("diffaug", hyper).apply(
            a, jax_diffaug_params(key, policy, x.shape)), x, 7)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(g_got, g_want, **TOL)


@pytest.mark.parametrize("mode,seed", [("simclr_hq", 0), ("simclr_hq", 1),
                                       ("simclr_hq_cutout", 2)])
def test_hq_chains_and_their_gradients_match_jax(mode, seed):
    x = _images(n=8, h=24, w=24, seed=seed)
    key = jax.random.PRNGKey(seed)
    got, want, g_got, g_want = _with_grad(
        lambda a: jax_get_augment(mode, HQ)(key, a),
        lambda a: get_augment(mode, HQ).apply(
            a, jax_simclr_params(key, 8, 24, 24, mode, HQ)), x, seed)
    np.testing.assert_allclose(got, want, **HSV_TOL)
    np.testing.assert_allclose(g_got, g_want, **HSV_TOL)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_every_jax_mode_samples_and_applies(mode):
    from contrad_tpu_torch.augment import AugRng

    port = get_augment(mode, HQ)
    shape = (4, 20, 20, 3)
    x = torch.rand(shape)
    out = port.apply(x, port.sample(shape, AugRng.from_seed(0, x.device)))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="simclr_lq"):
        get_augment("simclr_lq")
