"""The port's cDDLS chain (``contrad_tpu_torch/test_gan_sample_cddls.py``:
``energy``, ``langevin_step``) against the JAX CLI's
(``test_gan_sample_cddls.py:87-112``), restated here with the JAX package's
``make_g_apply`` / ``make_d_apply`` and ``jax.grad``: the energy, its
gradient in ``(z, z2)`` and three Langevin updates with the same Gaussian
draws (and, for StyleGAN2, the same noise maps of G at each step), for
``sndcgan`` (the pair of ``tests/test_torch_port_sndcgan.py``) and
``stylegan2_tiny`` at 8x8, batch 4, the CLI's ``eps``, ``sigma_n`` and
``lbd``, a random linear probe. SNDCGAN runs in float64, as its other
tests do; StyleGAN2 in float32, since XLA's float64 convolutions on the CPU
take about 10 s for one energy gradient there.

Tolerances: the energy and its gradients rtol 1e-3 / atol 1e-5; ``(z, z2)``
after the updates rtol 1e-4 / atol 1e-6."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.training.step import make_d_apply, make_g_apply
from contrad_tpu_torch.test_gan_sample_cddls import energy, langevin_step
from test_torch_port_sndcgan import build_sndcgan_pair
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, noise_list, one_torch_thread, t)

GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
N, EPS, SIGMA_N, LBD, Y, STEPS = 4, 0.01, 0.1, 1.0, 3, 3


def _sndcgan():
    G, D, g_vars, d_vars, port = build_sndcgan_pair(seed=4)
    pg, pd = port()
    z = np.random.default_rng(0).uniform(-1, 1, size=(N, G.nz))
    return (G, D, {"params": g_vars["params"],
                   "batch_stats": g_vars["batch_stats"]},
            {"params": d_vars["params"], "spectral": d_vars["spectral"]},
            pg, pd, z, None)


def _stylegan2():
    size = 8
    G, D, g_params, d_params, pg, pd = build_pair("stylegan2_tiny", size, 2)
    z = np.random.default_rng(0).normal(size=(N, pg.style_dim)).astype(
        np.float32)
    noise = [noise_list(pg, N, seed=20 + s) for s in range(STEPS)]
    return G, D, {"params": g_params}, {"params": d_params}, pg, pd, z, noise


@pytest.mark.parametrize("arch", ["sndcgan", "stylegan2_tiny"])
def test_energy_gradient_and_three_langevin_steps_match_jax(arch):
    G, D, g_vars, d_vars, pg, pd, z0, noise = (
        _sndcgan() if arch == "sndcgan" else _stylegan2())
    for p in list(pg.parameters()) + list(pd.parameters()):
        p.requires_grad_(False)
    size, dtype = (16, np.float64) if noise is None else (8, np.float32)
    rng = np.random.default_rng(1)
    w = rng.normal(scale=0.05, size=(pd.d_penul, 10)).astype(dtype)
    b = rng.normal(scale=0.05, size=(10,)).astype(dtype)
    z2_0 = rng.normal(size=(N, size, size, 3)).astype(dtype)
    draws = [(rng.normal(size=z0.shape).astype(dtype),
              rng.normal(size=z2_0.shape).astype(dtype))
             for _ in range(STEPS)]

    with jax.enable_x64(dtype == np.float64):
        g_apply, d_apply = make_g_apply(G), make_d_apply(D)
        g_params, g_state = g_vars["params"], {
            k: v for k, v in g_vars.items() if k != "params"}
        d_params, d_state = d_vars["params"], {
            k: v for k, v in d_vars.items() if k != "params"}

        # the CLI's energy, G's noise given; the weights are arguments, not
        # constants, which XLA would spend its time folding into the graph
        def jax_energy(z, z2, noise, g_params, d_params, w, b):
            kw = {} if noise is None else {"noise": noise}
            images, _ = g_apply(g_params, g_state, z, train=False,
                                update_state=False, **kw)
            images = images + EPS * z2
            (d_out, aux), _ = d_apply(d_params, d_state, images, train=False)
            logits = aux["penultimate"] @ w + b
            l_out = jnp.take(logits, Y, axis=1)[:, None]
            reg = 0.5 * jnp.sum(z2.reshape(z2.shape[0], -1) ** 2, axis=1,
                                keepdims=True)
            return jnp.sum(-(d_out + LBD * l_out) + reg)

        value_grad = jax.jit(jax.value_and_grad(jax_energy, argnums=(0, 1)))
        z, z2 = jnp.asarray(z0), jnp.asarray(z2_0)
        chain = []
        for s, (n_z, n_z2) in enumerate(draws):
            step_noise = None if noise is None else [jnp.asarray(a)
                                                     for a in noise[s]]
            e, (g_z, g_z2) = value_grad(z, z2, step_noise, g_params,
                                        d_params, w, b)
            chain.append((e, g_z, g_z2))
            z = z - 0.5 * EPS * g_z + SIGMA_N * math.sqrt(EPS) * n_z
            z2 = z2 - 0.5 * EPS * g_z2 + SIGMA_N * math.sqrt(EPS) * n_z2
            z = jnp.clip(z, -1.0, 1.0)
        z_want, z2_want = np.asarray(z), np.asarray(z2)

    wt, bt = t(w), t(b)
    zt, z2t = t(z0), t(z2_0)
    for s, ((e, g_z, g_z2), (n_z, n_z2)) in enumerate(zip(chain, draws)):
        step_noise = None if noise is None else [t(a) for a in noise[s]]
        zz = zt.clone().requires_grad_(True)
        zz2 = z2t.clone().requires_grad_(True)
        p_e = energy(pg, pd, wt, bt, zz, zz2, Y, EPS, LBD, step_noise)
        p_gz, p_gz2 = torch.autograd.grad(p_e, (zz, zz2))
        np.testing.assert_allclose(float(p_e.detach()), float(e), **GRAD_TOL)
        np.testing.assert_allclose(p_gz.numpy(), np.asarray(g_z), **GRAD_TOL)
        np.testing.assert_allclose(p_gz2.numpy(), np.asarray(g_z2),
                                   **GRAD_TOL)
        zt, z2t = langevin_step(pg, pd, wt, bt, zt, z2t, Y, EPS, SIGMA_N, LBD,
                                step_noise, t(n_z), t(n_z2))
    np.testing.assert_allclose(zt.numpy(), z_want, **STATE_TOL)
    np.testing.assert_allclose(z2t.numpy(), z2_want, **STATE_TOL)
    assert np.abs(z_want - z0).max() > 1e-4  # the chain moved
