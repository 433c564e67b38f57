"""The model variants of the JAX package's API that no registry
architecture builds, in the port against JAX on the same weights
(``contrad_tpu_torch/bridge.py``):

* ``models/base.py``: ``LinearDiscriminatorHead`` (the head of
  ``Discriminator(mlp_linear=False)``, JAX's default) with and without
  labels, its spectral-norm ``u`` after a persisting pass;
  ``NullDiscriminator``; ``projection``;
* ``models/stylegan2/discriminator.py``: ``ResidualDiscriminator``,
  ``SkipBlock`` and ``SkipDiscriminator``, forward and input gradient, and
  JAX's shape test of the two (``tests/test_stylegan2.py:226-241``);
* ``models/stylegan2/generator.py``: ``mean_latent`` (the port's
  ``torch.Generator`` draws fed to JAX's style MLP), ``input_is_latent``
  with one style a sample and one a layer, with and without style mixing,
  and ``return_latents``.

Discriminators compare in float64 (JAX under ``jax.enable_x64``; its
``ResidualBackbone`` given a float64 compute dtype, which
``ResidualDiscriminator`` leaves at float32; the backbone still hands its
head float32 features, so that head alone runs in float32 in JAX), as the
leaky-ReLU kinks of float32 move single gradient elements
(``tests/test_torch_port_sndcgan.py`` says so for SNDCGAN). Tolerances: forwards and state rtol 1e-4 / atol 1e-6,
gradients rtol 1e-3 / atol 1e-5; G in float32 at rtol 1e-4 / atol 1e-5, as
``tests/test_torch_port_models.py`` holds it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.models import base as jax_base
from contrad_tpu.models.sndcgan import DSndcgan as JaxD
from contrad_tpu.models.stylegan2 import discriminator as jax_sg2d
from contrad_tpu.training.step import make_d_apply
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models import NullDiscriminator, projection
from contrad_tpu_torch.models import base as port_base
from contrad_tpu_torch.models.sndcgan import DSndcgan
from contrad_tpu_torch.models.stylegan2 import discriminator as port_sg2d
from contrad_tpu_torch.ops.spectral_norm import commit_u
from test_torch_port_sndcgan import D_HIDDEN, IMG, N, NDF, _f64
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, noise_list, one_torch_thread, t, to_np)

TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
G_TOL = dict(rtol=1e-4, atol=1e-5)
N_CLASSES = 10
# tests/test_stylegan2.py's channel map for the two plain discriminators
CHANNELS = {4: 16, 8: 16, 16: 16, 32: 16}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=what)


def _sn_state(d_vars):
    return {"spectral": d_vars["spectral"]} if "spectral" in d_vars else {}


# ------------------------------------------------------------ the heads

@pytest.mark.parametrize("labels", [False, True])
def test_linear_head_matches_jax_with_its_u(labels):
    """``LinearDiscriminatorHead``: the score, with the class projection
    of the features where labels are given, and both layers' ``u`` after a
    persisting pass, from the same state."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, 12))
    y = rng.integers(0, N_CLASSES, size=N) if labels else None
    with jax.enable_x64(True):
        head = jax_base.LinearDiscriminatorHead(12, N_CLASSES)
        yj = jnp.zeros((2,), jnp.int32) if labels else None
        v = head.init(jax.random.PRNGKey(2), jnp.zeros((2, 12)), yj)
        v = {"params": _f64(v["params"]), "spectral": to_np(v["spectral"])}
        want, new = head.apply(v, jnp.asarray(x),
                               None if y is None else jnp.asarray(y),
                               train=True, mutable=["spectral"])
    # JAX makes linear_y where it sees labels; the port where n_classes > 1
    port = port_base.LinearDiscriminatorHead(
        12, use_sn=True, n_classes=N_CLASSES if labels else 1).double()
    port.load_state_dict(torch_state_dict(v["params"], _sn_state(v)),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if y is None else torch.from_numpy(y))
    commit_u(port)
    _close(got.numpy(), want, "score")
    state = torch_state_dict(to_np(new["spectral"]))
    assert set(state) == {k for k in port.state_dict() if k.endswith(".u")}
    for name, u in state.items():
        _close(port.state_dict()[name].numpy(), u.numpy(), name)


@pytest.fixture(scope="module")
def linear_pair():
    """JAX's conditional SNDCGAN D with the linear head (``mlp_linear``
    False, its default) in float64, and the port's twin in double."""
    with jax.enable_x64(True):
        D = JaxD(IMG, ndf=NDF, d_hidden=D_HIDDEN, dtype=jnp.float64,
                 n_classes=N_CLASSES)
        d_vars = jax.jit(lambda k: D.init(
            k, jnp.zeros((2,) + IMG), y=jnp.zeros((2,), jnp.int32),
            train=True))(jax.random.PRNGKey(5))
    d_vars = {"params": _f64(d_vars["params"]),
              "spectral": to_np(d_vars["spectral"])}

    def port():
        pd = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN,
                      n_classes=N_CLASSES).double()
        assert isinstance(pd.linear, port_base.LinearDiscriminatorHead)
        pd.load_state_dict(torch_state_dict(d_vars["params"],
                                            _sn_state(d_vars)), strict=True)
        return pd

    return D, d_vars, port


@pytest.mark.parametrize("labels", [False, True])
def test_discriminator_with_the_linear_head_matches_jax(linear_pair, labels):
    """``Discriminator(mlp_linear=False)``: the score and the heads, their
    gradients in the weights and the input, and every ``u`` after a
    persisting pass."""
    D, d_vars, port = linear_pair
    pd = port()
    rng = np.random.default_rng(4 + labels)
    x = rng.uniform(size=(N,) + IMG)
    y = rng.integers(0, N_CLASSES, size=N) if labels else None
    wts = {k: rng.normal(size=s) for k, s in (
        ("score", (N, 1)), ("projection", (N, 128)))}
    with jax.enable_x64(True):
        def loss(params, x):
            (d, aux), new = D.apply(
                {"params": params, "spectral": d_vars["spectral"]}, x,
                y=None if y is None else jnp.asarray(y), train=True,
                mutable=["spectral"])
            out = {"score": d, "projection": aux["projection"]}
            return sum(jnp.sum(out[k] * wts[k]) for k in wts), (out, new)

        (_, (want, new)), (g_params, g_x) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(d_vars["params"],
                                                jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    d, aux = pd(xt, None if y is None else torch.from_numpy(y))
    out = {"score": d, "projection": aux["projection"]}
    params = dict(pd.named_parameters())
    grads = torch.autograd.grad(
        sum((out[k] * torch.from_numpy(wts[k])).sum() for k in wts),
        list(params.values()) + [xt], allow_unused=True,
        materialize_grads=True)
    commit_u(pd)
    for k in wts:
        _close(out[k].detach().numpy(), want[k], k)
    want_g = torch_state_dict(to_np(g_params))
    assert set(want_g) == set(params)
    for (name, _), g in zip(params.items(), grads[:-1]):
        _close(g.numpy(), want_g[name].numpy(), name, GRAD_TOL)
    _close(grads[-1].numpy(), g_x, "input", GRAD_TOL)
    for name, u in torch_state_dict(to_np(new["spectral"])).items():
        _close(pd.state_dict()[name].numpy(), u.numpy(), name)


def test_projection_and_null_discriminator_match_jax(linear_pair):
    D, d_vars, port = linear_pair
    pd = port()
    x = np.random.default_rng(7).uniform(size=(N,) + IMG)
    with jax.enable_x64(True):
        d_apply = make_d_apply(D)
        want, new = jax_base.projection(d_apply, d_vars["params"],
                                        {"spectral": d_vars["spectral"]},
                                        jnp.asarray(x))
        null = jax_base.NullDiscriminator()
        null_want = null.apply({}, jnp.asarray(x))
    with torch.no_grad():
        got = projection(pd, torch.from_numpy(x))
    commit_u(pd)
    _close(got.numpy(), want, "projection")
    for name, u in torch_state_dict(to_np(new["spectral"])).items():
        _close(pd.state_dict()[name].numpy(), u.numpy(), name)
    got = NullDiscriminator()(torch.from_numpy(x))
    assert got.shape == (N, 1)
    _close(got.numpy(), null_want, "null score")


def test_registry_architectures_keep_the_mlp_head():
    """The registry passes ``mlp_linear=True`` wherever JAX's does, so no
    registry architecture changed with the port's default."""
    from contrad_tpu_torch.models import get_architecture

    for arch in ("sndcgan", "snresnet18", "stylegan2", "stylegan2_tiny"):
        _, d = get_architecture(arch, (32, 32, 3), device="cpu")
        assert isinstance(d.linear, port_base.TinyDiscriminatorHead), arch


# ------------------------------------------- the plain StyleGAN2 Ds

@pytest.fixture
def small_channels(monkeypatch):
    """JAX's shape test's channel map in both packages, and JAX's residual
    backbone computing in float64."""
    monkeypatch.setattr(jax_sg2d, "stylegan2_channels",
                        lambda *a, **k: dict(CHANNELS))
    monkeypatch.setattr(port_sg2d, "stylegan2_channels",
                        lambda *a, **k: dict(CHANNELS))
    monkeypatch.setattr(jax_sg2d, "ResidualBackbone", functools.partial(
        jax_sg2d.ResidualBackbone, dtype=jnp.float64))


@pytest.mark.parametrize("name", ["ResidualDiscriminator",
                                  "SkipDiscriminator"])
def test_plain_discriminators_match_jax(small_channels, name):
    """The score and its gradient in the input, at 32x32, batch 4 (JAX's
    shape test, ``tests/test_stylegan2.py:226-241``, held to values)."""
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(4, 32, 32, 3))
    wt = rng.normal(size=(4, 1))
    with jax.enable_x64(True):
        d = getattr(jax_sg2d, name)(size=32, small32=True)
        v = jax.jit(lambda k, xx: d.init(k, xx, train=True))(
            jax.random.PRNGKey(9), jnp.zeros((2, 32, 32, 3)))
        params = _f64(v["params"])

        def loss(x):
            out = d.apply({"params": params}, x, train=True)
            return jnp.sum(out * wt), out

        (_, want), g_x = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(x))
    assert want.shape == (4, 1)
    port = getattr(port_sg2d, name)(size=32, small32=True).double()
    port.load_state_dict(torch_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (g,) = torch.autograd.grad((out * torch.from_numpy(wt)).sum(), xt)
    assert out.shape == (4, 1)
    _close(out.detach().numpy(), want, "score")
    _close(g.numpy(), g_x, "input gradient", GRAD_TOL)


def test_skip_block_matches_jax(np_rng):
    """``SkipBlock`` alone, with and without incoming features: the
    downsampled image and the features (the image's downsample runs
    through the blur's plain version here, its kernel on the card)."""
    x = np_rng.uniform(-1, 1, size=(2, 16, 16, 3))
    feats = np_rng.normal(size=(2, 16, 16, 8))
    with jax.enable_x64(True):
        blk = jax_sg2d.SkipBlock(8, 12)
        v = blk.init(jax.random.PRNGKey(1), jnp.asarray(x))
        params = _f64(v["params"])
        want = [blk.apply({"params": params}, jnp.asarray(x), f)
                for f in (None, jnp.asarray(feats))]
    port = port_sg2d.SkipBlock(8, 12).double()
    port.load_state_dict(torch_state_dict(params), strict=True)
    for f, (img_want, f_want) in zip((None, torch.from_numpy(feats)), want):
        with torch.no_grad():
            img, got = port(torch.from_numpy(x), f)
        assert img.shape == (2, 8, 8, 3) and got.shape == (2, 8, 8, 12)
        _close(img.numpy(), img_want, "downsampled image")
        _close(got.numpy(), f_want, "features")


# ------------------------------------------------------------ G

@pytest.fixture(scope="module")
def pair16():
    return build_pair("stylegan2", 16, seed=0)


def test_mean_latent_matches_jax_on_the_same_draws(pair16):
    G, _, g_params, _, pg, _ = pair16
    gen = torch.Generator().manual_seed(11)
    z = pg.sample_latent(64, torch.Generator().manual_seed(11))
    with torch.no_grad():
        got = pg.mean_latent(64, gen)
    want = G.apply({"params": g_params}, jnp.asarray(z.numpy()),
                   method=lambda m, z: jnp.mean(m.style_forward(z), axis=0,
                                                keepdims=True))
    assert got.shape == (1, G.style_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **G_TOL)


@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_generator_from_latents_matches_jax(pair16, per_layer, train):
    """``input_is_latent`` with a style a sample (N, 512) or a layer
    (N, n_latent, 512); in training, style mixing replaces the layers
    from each crossover with the mapped second latent, as JAX mixes a
    latent input; ``return_latents`` returns the mixed styles."""
    G, _, g_params, _, pg, _ = pair16
    n = 3
    rng = np.random.default_rng(12)
    shape = (n, G.n_latent, 512) if per_layer else (n, 512)
    w = rng.normal(size=shape).astype(np.float32)
    noise = noise_list(G, n, seed=13)
    key = jax.random.PRNGKey(14)
    variables = {"params": g_params}
    want, want_lat = G.apply(
        variables, jnp.asarray(w), train=train, style_mix=0.9,
        input_is_latent=True, noise=[jnp.asarray(a) for a in noise],
        return_latents=True, rngs={"noise": key})
    mixing = jax_mixing(G, variables, key, n) if train else None
    with torch.no_grad():
        got, lat = pg(t(w), [t(a) for a in noise], mixing, train=train,
                      input_is_latent=True, return_latents=True)
        plain = pg(t(w), [t(a) for a in noise], mixing, train=train,
                   input_is_latent=True)
    assert got.shape == (n, 16, 16, 3) and lat.shape == (n, G.n_latent, 512)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **G_TOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), **G_TOL)


def test_generator_returns_its_mapped_latents(pair16):
    """``return_latents`` from z: the style MLP's w on every layer."""
    G, _, g_params, _, pg, _ = pair16
    z = np.random.default_rng(15).normal(size=(2, 512)).astype(np.float32)
    noise = noise_list(G, 2, seed=16)
    want, want_lat = G.apply({"params": g_params}, jnp.asarray(z),
                             train=False, noise=[jnp.asarray(a)
                                                 for a in noise],
                             return_latents=True)
    with torch.no_grad():
        got, lat = pg(t(z), [t(a) for a in noise], train=False,
                      return_latents=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **G_TOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), **G_TOL)
