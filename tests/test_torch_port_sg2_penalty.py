"""``train_stylegan2 --penalty``: the port's ``StyleGAN2Trainer.train_step``
with each of the ``gp``, ``cr`` and ``bcr`` penalties against the JAX
package's ``StyleGAN2Trainer._sg2_step``, which adds the penalty to the
first critic sub-step through ``loss_D`` (``contrad_tpu/training/
step.py:496-500``). ``stylegan2_tiny`` on 8x8 images, batch 4, the ``std``
mode, float64 in both packages (a leaky-ReLU kink inside a gradient of a
gradient bites in float32), on the same weights and the same draws: z,
noise and style mixing of the G phase and the penalty's alpha or
augmentation, reproduced from the JAX step's keys. Checked: the losses
(the penalty among them, which must be positive), both phases' gradients,
read off plain SGD updates, and the parameters after the step.

Tolerances: those of ``tests/test_torch_port_gan_step.py`` (losses and
gradients rtol 1e-3 / atol 1e-5; parameters rtol 1e-5 / atol 1e-6)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import StyleGAN2Trainer as JaxSG2Trainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.training import StyleGAN2Trainer
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_gan_step import (
    LR, UPDATE_TOL, RecordingSGD, _compare_grads, _compare_metrics,
    jax_d_draws)
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, noise_list, one_torch_thread, t, to_np)

N, SIZE = 4, 8


@pytest.fixture(scope="module")
def pair():
    return build_pair("stylegan2_tiny", SIZE, 3)


@pytest.mark.parametrize("penalty", ["gp", "cr", "bcr"])
def test_stylegan2_step_with_penalty_matches_jax(pair, penalty):
    _, _, g_params, d_params, pg, pd = pair
    pg, pd = copy.deepcopy(pg).double(), copy.deepcopy(pd).double()
    img = (SIZE, SIZE, 3)
    noise = [a.astype(np.float64) for a in noise_list(pg, N, seed=21)]
    images = np.random.default_rng(22).uniform(size=(N,) + img)
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    with jax.enable_x64(True):
        G, D = jax_get_architecture("stylegan2_tiny", img, dtype=jnp.float64)
        g_params, d_params = f64(g_params), f64(d_params)
        tx = optax.sgd(LR)
        jt = JaxSG2Trainer(G, D, mode="std",
                           augment_fn=jax_get_augment("simclr"),
                           g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                           penalty=penalty, lbd=10.0, lbd2=5.0, lbd_r1=0.1,
                           d_reg_every=1, n_critic=1,
                           g_kwargs={"style_mix": 0.9,
                                     "noise": [jnp.asarray(a) for a in noise]})
        key = jax.random.PRNGKey(23)
        state = GANTrainState(
            step=jnp.zeros((), jnp.int32), rng=key, g_params=g_params,
            g_state={}, d_params=d_params, d_state={},
            g_opt_state=tx.init(g_params), d_opt_state=tx.init(d_params),
            g_ema_params=g_params, g_ema_state={})
        new, metrics = jax.jit(jt._sg2_step, static_argnums=(3,))(
            state, jnp.asarray(images), 0.9, False)

        # the draws of _sg2_step (step.py:482-500), in the port's form
        rng, z_rng, noise_rng, _ = jax.random.split(key, 4)
        g_draws = ({"z": t(G.sample_latent(z_rng, N)),
                    "noise": [t(a) for a in noise],
                    "mixing": jax_mixing(G, {"params": g_params}, noise_rng,
                                         N)}, None)
        _, d_loss_rng, _ = jax.random.split(rng, 3)
        critic = [(None, jax_d_draws("std", penalty, d_loss_rng, N, img))]
    new, metrics = to_np(new), to_np(metrics)

    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = StyleGAN2Trainer(pg, pd, mode="std",
                               augment=get_augment("simclr"),
                               g_optimizer=g_tx, d_optimizer=d_tx,
                               loss_type="nonsat", penalty=penalty, lbd=10.0,
                               lbd2=5.0, lbd_r1=0.1, d_reg_every=1)
    got = trainer.train_step(t(images), ema_decay=0.9,
                             draws=StepDraws(None, critic, g_draws))
    assert float(got["D_penalty"]) > 0
    _compare_metrics(dict(metrics=got, jax_metrics=metrics))
    _compare_grads(dict(jax_old=({"params": g_params}, {"params": d_params}),
                        jax=new, trainer=trainer, g_tx=g_tx, d_tx=d_tx))
    for module, params in ((pd, new.d_params), (pg, new.g_params)):
        want = torch_state_dict(params)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **UPDATE_TOL, err_msg=name)


def test_stylegan2_trainer_draws_the_penalty(pair):
    """Without draws passed in, the first critic sub-step gets the
    penalty's: gp's alpha, one per real; cr's augmentation of the reals;
    bcr's of the reals and the fakes."""
    *_, pg, pd = pair
    for penalty, want in (("gp", (N,)), ("cr", N), ("bcr", 2 * N)):
        trainer = StyleGAN2Trainer(pg, pd, mode="std",
                                   augment=get_augment("simclr"),
                                   g_optimizer=None, d_optimizer=None,
                                   loss_type="nonsat", penalty=penalty)
        draws = trainer.draw_step((N, SIZE, SIZE, 3))
        (g_draws, first), = draws.critic
        assert g_draws is None
        if penalty == "gp":
            assert tuple(first.penalty.shape) == want
        else:
            assert first.penalty[0]["sx"].shape[0] == want
