"""The port's StyleGAN2 G and D (``contrad_tpu_torch/models``) against the
JAX package on the same weights, through ``contrad_tpu_torch/bridge.py``.
JAX runs its default path, with the blurs folded into the convs; the port
runs the unfused form (blur kernel, then conv), the same function.

Tolerance: rtol 1e-4 / atol 1e-5 (f32 convs summed in other orders, and
the fused vs unfused blur)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, noise_list, one_torch_thread, t)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair16():
    return build_pair("stylegan2", 16, seed=0)


@pytest.mark.parametrize("train", [False, True])
def test_generator_matches_jax(pair16, train):
    G, _, g_params, _, pg, _ = pair16
    n = 3
    z = np.random.default_rng(3).normal(size=(n, 512)).astype(np.float32)
    noise = noise_list(G, n, seed=4)
    key = jax.random.PRNGKey(5)
    variables = {"params": g_params}
    want = G.apply(variables, jnp.asarray(z), train=train, style_mix=0.9,
                   noise=[jnp.asarray(a) for a in noise], rngs={"noise": key})
    mixing = jax_mixing(G, variables, key, n) if train else None
    with torch.no_grad():
        got = pg(t(z), [t(a) for a in noise], mixing, train=train)
    assert got.shape == (n, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_discriminator_matches_jax(pair16):
    _, D, _, d_params, _, pd = pair16
    x = np.random.default_rng(6).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    d_want, aux_want = D.apply({"params": d_params}, jnp.asarray(x), train=True)
    with torch.no_grad():
        d_got, aux_got = pd(t(x))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), **TOL)
    for k in ("penultimate", "projection", "projection2"):
        np.testing.assert_allclose(aux_got[k].numpy(), np.asarray(aux_want[k]),
                                   **TOL, err_msg=k)


def test_sg_linear_detaches_only_the_gan_head(pair16):
    *_, pd = pair16
    x = torch.rand(4, 16, 16, 3)
    d, aux = pd(x, sg_linear=True)
    conv_w = pd.backbone.from_rgb.conv.conv.weight
    (g_head,) = torch.autograd.grad(d.sum(), conv_w, allow_unused=True)
    assert g_head is None
    (g_proj,) = torch.autograd.grad(aux["projection"].sum(), conv_w)
    assert float(g_proj.abs().sum()) > 0


@pytest.mark.parametrize("n", [4, 8, 3, 6])
def test_minibatch_stddev_matches_jax(n):
    from contrad_tpu.models.stylegan2.discriminator import (
        minibatch_stddev as jax_mbstd)
    from contrad_tpu_torch.models.stylegan2 import minibatch_stddev

    x = np.random.default_rng(n).normal(size=(n, 4, 4, 6)).astype(np.float32)
    if n % min(n, 4):
        with pytest.raises(RuntimeError):
            minibatch_stddev(t(x))
        return
    np.testing.assert_allclose(minibatch_stddev(t(x)).numpy(),
                               np.asarray(jax_mbstd(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("kernel_size", [3, 1])
def test_downsample_convlayer_matches_jax_fused(kernel_size):
    """Blur -> stride-2 conv (the port) == the conv with the blur folded in
    (JAX's default)."""
    from contrad_tpu.models.stylegan2.layers import ConvLayer as JaxConvLayer
    from contrad_tpu_torch.bridge import torch_state_dict
    from contrad_tpu_torch.models.stylegan2.layers import ConvLayer

    x = np.random.default_rng(7).normal(size=(2, 16, 16, 8)).astype(np.float32)
    layer = JaxConvLayer(12, kernel_size, downsample=True, activate=True)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = layer.apply({"params": params}, jnp.asarray(x))
    port = ConvLayer(8, 12, kernel_size, downsample=True, activate=True)
    port.load_state_dict(torch_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_upsample_modulated_conv_matches_jax():
    """conv_transpose (kernel flipped for torch) -> demod -> blur."""
    from contrad_tpu.models.stylegan2.generator import (
        ModulatedConv as JaxModulatedConv)
    from contrad_tpu_torch.bridge import torch_state_dict
    from contrad_tpu_torch.models.stylegan2.generator import ModulatedConv

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)
    s = rng.normal(size=(2, 16)).astype(np.float32)
    conv = JaxModulatedConv(7, 3, upsample=True)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(s))["params"]
    want = conv.apply({"params": params}, jnp.asarray(x), jnp.asarray(s))
    port = ModulatedConv(6, 7, 3, 16, upsample=True)
    port.load_state_dict(torch_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(t(x), t(s))
    assert got.shape == (2, 10, 10, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_upsample2d_matches_jax():
    from contrad_tpu.ops.upfirdn2d import make_kernel as jax_mk
    from contrad_tpu.ops.upfirdn2d import upsample2d as jax_up
    from contrad_tpu_torch.ops.upfirdn2d import make_kernel, upsample2d

    x = np.random.default_rng(9).normal(size=(2, 6, 5, 3)).astype(np.float32)
    want = jax_up(jnp.asarray(x), jax_mk([1, 3, 3, 1]))
    got = upsample2d(t(x), make_kernel([1, 3, 3, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
