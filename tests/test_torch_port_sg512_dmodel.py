"""The 512x512 recipe's StyleGAN2 D in the port against the JAX package's
packed D (its stem laid out space-to-depth), at 128x128 with
``channel_multiplier`` 0.25, in float64, batch 2: the score, the
contrastive heads' outputs and the gradients of both with respect to D's
parameters and its input. The set-up and the tolerances are
``tests/test_torch_port_sg512_models.py``'s, which says why."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_sg512_models import (
    FWD_TOL, GRAD_TOL, N, SIZE, assert_grads, pair128_f64)
from torch_port_jax import one_torch_thread, t  # noqa: F401  (autouse)


def test_discriminator_and_its_gradients_match_jax_packed():
    _, D, _, d_params, _, pd = pair128_f64(seed=2)
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(N, SIZE, SIZE, 3))
    w = {k: rng.normal(size=s) for k, s in (
        ("score", (N, 1)), ("penultimate", (N, 512 * 16)),
        ("projection", (N, 128)), ("projection2", (N, 128)))}
    with jax.enable_x64(True):
        def loss(params, x):
            d, aux = D.apply({"params": params}, x, train=True)
            out = {"score": d, **aux}
            return sum(jnp.sum(out[k] * w[k]) for k in w), out

        (_, want), (g_params, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(d_params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    d, aux = pd(xt)
    out = {"score": d, **aux}
    grads = torch.autograd.grad(sum((out[k] * t(w[k])).sum() for k in w),
                                list(pd.parameters()) + [xt])
    for k in w:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(want[k]), **FWD_TOL, err_msg=k)
    assert_grads(grads[:-1], [k for k, _ in pd.named_parameters()], g_params)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(g_x), **GRAD_TOL,
                               err_msg="input")
