"""The port's losses (``contrad_tpu_torch/training/losses.py``): the golden
cases of ``tests/test_losses.py`` (numpy oracles written from the loss
definitions) and the JAX functions on the same inputs.

Tolerance: rtol 1e-5, as ``tests/test_losses.py`` (1e-4 for the normalised
case, as there); gradients rtol 1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.training import losses as jl
from contrad_tpu_torch.training.losses import (
    gan_d_loss, gan_g_loss, nt_xent, supcon_fake)


def _np_log_softmax(x):
    x = x - x.max(axis=1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=1, keepdims=True))


def _np_nt_xent(a, b, temp):
    n = a.shape[0]
    out = np.concatenate([a, b], 0)
    sim = out @ out.T / temp
    np.fill_diagonal(sim, -5e4)
    lsm = _np_log_softmax(sim)
    pos = np.array([lsm[i, i + n] for i in range(n)]
                   + [lsm[i + n, i] for i in range(n)])
    return -pos.sum() / (2 * n)


def _np_supcon_fake(a, b, others, temp):
    n, m = a.shape[0], others.shape[0]
    out = np.concatenate([a, b, others], 0)
    sim = out @ out.T / temp
    np.fill_diagonal(sim, -5e4)
    lsm = _np_log_softmax(sim[2 * n:])
    total = 0.0
    for i in range(m):
        total += lsm[i, [2 * n + j for j in range(m) if j != i]].mean()
    return -total / m


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("n,d,temp", [(4, 8, 0.1), (7, 16, 0.5)])
def test_nt_xent_matches_numpy_and_jax(n, d, temp, np_rng):
    a = np_rng.normal(size=(n, d)).astype(np.float32)
    b = np_rng.normal(size=(n, d)).astype(np.float32)
    got = float(nt_xent(_t(a), _t(b), temperature=temp))
    np.testing.assert_allclose(got, _np_nt_xent(a, b, temp), rtol=1e-5)
    np.testing.assert_allclose(
        got, float(jl.nt_xent(jnp.asarray(a), jnp.asarray(b), temp)),
        rtol=1e-5)


def test_nt_xent_normalize_flag(np_rng):
    a = np_rng.normal(size=(5, 8)).astype(np.float32) * 3
    b = np_rng.normal(size=(5, 8)).astype(np.float32) * 3
    an = a / np.linalg.norm(a, axis=1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=1, keepdims=True)
    got = float(nt_xent(_t(a), _t(b), temperature=0.2, normalize=True))
    np.testing.assert_allclose(got, _np_nt_xent(an, bn, 0.2), rtol=1e-4)


def test_nt_xent_perfect_alignment_low_loss():
    a = torch.eye(8) * 10
    assert float(nt_xent(a, a)) < float(nt_xent(a, torch.roll(a, 1, 0)))


@pytest.mark.parametrize("n,m", [(4, 4), (3, 5)])
def test_supcon_fake_matches_numpy_and_jax(n, m, np_rng):
    a = np_rng.normal(size=(n, 8)).astype(np.float32)
    b = np_rng.normal(size=(n, 8)).astype(np.float32)
    o = np_rng.normal(size=(m, 8)).astype(np.float32)
    got = float(supcon_fake(_t(a), _t(b), _t(o), temperature=0.1))
    np.testing.assert_allclose(got, _np_supcon_fake(a, b, o, 0.1), rtol=1e-5)
    np.testing.assert_allclose(
        got, float(jl.supcon_fake(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(o), 0.1)), rtol=1e-5)


def test_nonsat_gan_losses(np_rng):
    r = np_rng.normal(size=(6, 1)).astype(np.float32)
    g = np_rng.normal(size=(6, 1)).astype(np.float32)
    np.testing.assert_allclose(
        float(gan_d_loss(_t(r), _t(g), "nonsat")),
        np.logaddexp(0, g).mean() + np.logaddexp(0, -r).mean(), rtol=1e-5)
    np.testing.assert_allclose(float(gan_g_loss(_t(g), "nonsat")),
                               np.logaddexp(0, -g).mean(), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        gan_d_loss(_t(r), _t(g), "unknown")


def test_contrastive_gradients_match_jax(np_rng):
    a = np_rng.normal(size=(4, 8)).astype(np.float32)
    b = np_rng.normal(size=(4, 8)).astype(np.float32)
    o = np_rng.normal(size=(3, 8)).astype(np.float32)

    def jax_total(a, b, o):
        return jl.nt_xent(a, b, 0.1) + jl.supcon_fake(a, b, o, 0.1)

    want = jax.grad(jax_total, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(o))
    ts = [_t(v).requires_grad_(True) for v in (a, b, o)]
    got = torch.autograd.grad(
        nt_xent(ts[0], ts[1]) + supcon_fake(*ts, temperature=0.1), ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
