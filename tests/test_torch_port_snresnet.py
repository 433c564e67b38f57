"""``snresnet18`` (``contrad_tpu_torch/models/snresnet.py``) against the
JAX package on the same weights and spectral-norm state
(``contrad_tpu_torch/bridge.py``), at 32x32, the size its 4x4 pool needs;
the ResNet-18 widths are fixed (64-512 channels), the heads narrowed to
``d_hidden = 64`` and G to ngf = 16, nz = 32. Batch 2 (the stack has no
minibatch statistics). Both packages run in float64, as
``tests/test_torch_port_sndcgan.py`` explains; the stored ``u`` stays
float32 in JAX.

Checked: D in train and eval mode (score, penultimate features, both
projections), every ``u`` after one and after two persisting forwards, a
non-persisting pass leaving ``u`` alone, D's gradients (parameters and
input) of a loss on all its outputs, one ``GANTrainer`` ``contrad`` step
(losses, both phases' gradients read off SGD updates, ``u`` and the
batch-norm statistics after it), and the registry's ``snresnet18``.

Tolerances: forwards and state rtol 1e-4 / atol 1e-6; losses and gradients
rtol 1e-3 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.models.sndcgan import GSndcgan as JaxG
from contrad_tpu.models.snresnet import DSnresnet18 as JaxD
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models import get_architecture
from contrad_tpu_torch.models.sndcgan import GSndcgan
from contrad_tpu_torch.models.snresnet import DSnresnet18, SnresnetBackbone
from contrad_tpu_torch.ops.spectral_norm import commit_u
from test_torch_port_gan_step import (
    _compare_grads, _compare_metrics, _compare_state, run_case)
from torch_port_jax import one_torch_thread, t, to_np  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
IMG, NGF, NZ, D_HIDDEN, N = (32, 32, 3), 16, 32, 64, 2


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(True):
        G = JaxG(IMG, ngf=NGF, nz=NZ, dtype=jnp.float64)
        D = JaxD(mlp_linear=True, d_hidden=D_HIDDEN, dtype=jnp.float64)
        kg, kd = jax.random.split(jax.random.PRNGKey(3))
        g_vars = jax.jit(lambda k: G.init(k, jnp.zeros((2, NZ)),
                                          train=True))(kg)
        d_vars = jax.jit(lambda k: D.init(k, jnp.zeros((2,) + IMG),
                                          train=True))(kd)
    g_vars = {"params": _f64(g_vars["params"]),
              "batch_stats": _f64(g_vars["batch_stats"])}
    d_vars = {"params": _f64(d_vars["params"]),
              "spectral": to_np(d_vars["spectral"])}

    def port():
        pg = GSndcgan(IMG, ngf=NGF, nz=NZ).double()
        pd = DSnresnet18(mlp_linear=True, d_hidden=D_HIDDEN).double()
        pg.load_state_dict(torch_state_dict(
            g_vars["params"], {"batch_stats": g_vars["batch_stats"]}),
            strict=True)
        pd.load_state_dict(torch_state_dict(
            d_vars["params"], {"spectral": d_vars["spectral"]}), strict=True)
        return pg, pd

    return G, D, g_vars, d_vars, port


def _images(seed=0):
    return np.random.default_rng(seed).uniform(size=(N,) + IMG)


def _outputs(d, aux):
    return {"score": d, **aux}


def _assert_u(module, jax_state):
    want = torch_state_dict({}, jax_state)
    have = module.state_dict()
    # 20 convs (the stem, two per block, three shortcuts), 6 head layers
    assert len(want) == 26
    for name, w in want.items():
        np.testing.assert_allclose(have[name].numpy(), w.numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(pair, train):
    _, D, _, d_vars, port = pair
    x = _images(1)
    with jax.enable_x64(True):
        if train:
            (d, aux), _ = D.apply(d_vars, x, train=True, mutable=["spectral"])
        else:
            d, aux = D.apply(d_vars, x, train=False)
    _, pd = port()
    with torch.no_grad():
        got = _outputs(*pd(t(x), train=train))
    want = _outputs(d, aux)
    assert set(got) == set(want)
    assert got["penultimate"].shape == (N, 512)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), **TOL,
                                   err_msg=k)


def test_u_after_two_persisting_forwards_and_a_non_persisting_one(pair):
    _, D, _, d_vars, port = pair
    variables = dict(d_vars)
    _, pd = port()
    for seed in (2, 3):
        x = _images(seed)
        with jax.enable_x64(True):
            _, new = D.apply(variables, x, train=True, mutable=["spectral"])
        variables = dict(variables, **to_np(new))
        with torch.no_grad():
            pd(t(x), train=True)
        commit_u(pd)
        _assert_u(pd, {"spectral": variables["spectral"]})
    with torch.no_grad():
        pd(t(_images(4)), train=True, persist=False)
    commit_u(pd)
    _assert_u(pd, {"spectral": variables["spectral"]})


def test_discriminator_gradients_match_jax(pair):
    _, D, _, d_vars, port = pair
    x = _images(5)
    rng = np.random.default_rng(6)
    w = {k: rng.normal(size=s) for k, s in (
        ("score", (N, 1)), ("penultimate", (N, 512)),
        ("projection", (N, 128)), ("projection2", (N, 128)))}

    def loss(params, x):
        (d, aux), _ = D.apply(dict(d_vars, params=params), x, train=True,
                              mutable=["spectral"])
        out = _outputs(d, aux)
        return sum(jnp.sum(out[k] * w[k]) for k in w)

    with jax.enable_x64(True):
        g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            d_vars["params"], jnp.asarray(x))
    _, pd = port()
    xt = t(x).requires_grad_(True)
    out = _outputs(*pd(xt, train=True))
    total = sum((out[k] * t(w[k])).sum() for k in w)
    names = [k for k, _ in pd.named_parameters()]
    grads = torch.autograd.grad(total, list(pd.parameters()) + [xt])
    want = torch_state_dict(to_np(g_params))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(g_x), **GRAD_TOL)


def test_contrad_step_matches_jax(pair):
    """The flagship's mode on this D: losses, both phases' gradients, the
    parameters after SGD, ``u`` and G's batch-norm statistics after the
    step."""
    r = run_case(pair, "contrad", n=N)
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)


def test_registry_snresnet18():
    G, D = get_architecture("snresnet18", (32, 32, 3), device="cpu", seed=0)
    assert isinstance(G, GSndcgan)
    assert isinstance(D.backbone, SnresnetBackbone)
    assert D.linear.l1.weight.shape == (1024, 512)
    with torch.no_grad():
        d, aux = D(G(torch.rand(2, 128) * 2 - 1))
    assert d.shape == (2, 1) and aux["projection"].shape == (2, 128)


def test_train_gan_cli_runs_snresnet18():
    """The flagship's recipe with the ``snresnet18`` D: two CPU steps of
    ``python -m contrad_tpu_torch.train_gan``, finite."""
    from contrad_tpu_torch.train_gan import main

    history = main(["configs/gan/cifar10/c10_b512.toml", "snresnet18",
                    "--mode", "contrad", "--aug", "simclr", "--use_warmup",
                    "--device", "cpu", "--print_every", "1", "--override",
                    "options.dataset=synthetic_32", "options.batch_size=4",
                    "options.max_steps=2"])
    assert [r["step"] for r in history] == [1, 2]
    for rec in history:
        for k in ("D_loss", "D_penalty", "D_real", "D_gen", "G_loss"):
            assert np.isfinite(rec[k]), k
