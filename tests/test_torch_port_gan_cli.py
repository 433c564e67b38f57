"""The StyleGAN2 trainer with ``n_critic = 2`` and the new CLI of the port:

  * ``StyleGAN2Trainer.train_step`` against ``StyleGAN2Trainer._sg2_step``
    at the ``stylegan2_tiny`` width on 8x8 images, batch 4, float64 in both
    packages, on the same weights and draws (z, noise, style mixing,
    reproduced from the JAX step's keys): the G phase, the D phase on its
    fakes, then a D sub-step on fresh reals and fresh fakes. In the ``std``
    mode: the sub-steps' order and draws do not depend on the mode, and the
    unaugmented step compiles in a fraction of the time. Checked: the last
    sub-step's losses and G_loss, both phases' gradients (read off plain SGD
    updates, as in ``tests/test_torch_port_gan_step.py``), the parameters
    after the updates and the EMA of G's pre-update parameters;
  * three CPU steps of ``python -m contrad_tpu_torch.train_gan`` with the
    flagship's flags at the registry's full width: finite, and the same
    twice from one seed.

Tolerances: those of ``tests/test_torch_port_gan_step.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import StyleGAN2Trainer as JaxSG2Trainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.training import StyleGAN2Trainer
from contrad_tpu_torch.training.modes import Draws
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_gan_step import (
    GRAD_TOL, LR, UPDATE_TOL, RecordingSGD, _compare_grads, _compare_metrics)
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, noise_list, one_torch_thread, t, to_np)


def test_stylegan2_two_critic_steps_match_jax():
    n, size = 4, 8
    _, _, g_params, d_params, pg, pd = build_pair("stylegan2_tiny", size, 1)
    pg, pd = pg.double(), pd.double()
    rng = np.random.default_rng(12)
    noise = [a.astype(np.float64) for a in noise_list(pg, n, seed=13)]
    images = rng.uniform(size=(2 * n, size, size, 3))
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    with jax.enable_x64(True):
        G, D = jax_get_architecture("stylegan2_tiny", (size, size, 3),
                                    dtype=jnp.float64)
        g_params, d_params = f64(g_params), f64(d_params)
        tx = optax.sgd(LR)
        jt = JaxSG2Trainer(G, D, mode="std",
                           augment_fn=jax_get_augment("simclr"),
                           g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                           lbd_r1=0.1, d_reg_every=1, n_critic=2,
                           g_kwargs={"style_mix": 0.9,
                                     "noise": [jnp.asarray(a) for a in noise]})
        key = jax.random.PRNGKey(14)
        state = GANTrainState(
            step=jnp.zeros((), jnp.int32), rng=key, g_params=g_params,
            g_state={}, d_params=d_params, d_state={},
            g_opt_state=tx.init(g_params), d_opt_state=tx.init(d_params),
            g_ema_params=g_params, g_ema_state={})
        new, metrics = jax.jit(jt._sg2_step, static_argnums=(3,))(
            state, jnp.asarray(images), 0.9, False)

        # the draws of _sg2_step (step.py:482-534), in the port's form
        variables = {"params": g_params}
        noise_t = [t(a) for a in noise]
        rng, z_rng, noise_rng, _ = jax.random.split(key, 4)
        g_draws = ({"z": t(G.sample_latent(z_rng, n)), "noise": noise_t,
                    "mixing": jax_mixing(G, variables, noise_rng, n)}, None)
        rng, _, _ = jax.random.split(rng, 3)
        rng, z_rng, noise_rng, _, _ = jax.random.split(rng, 5)
        critic = [
            (None, Draws()),
            ({"z": t(G.sample_latent(z_rng, n)), "noise": noise_t,
              "mixing": jax_mixing(G, variables, noise_rng, n)}, Draws())]
    new, metrics = to_np(new), to_np(metrics)

    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = StyleGAN2Trainer(pg, pd, mode="std",
                               augment=get_augment("simclr"),
                               g_optimizer=g_tx, d_optimizer=d_tx,
                               loss_type="nonsat", lbd_r1=0.1, d_reg_every=1,
                               n_critic=2)
    got = trainer.train_step(t(images), ema_decay=0.9,
                             draws=StepDraws(None, critic, g_draws))
    assert len(d_tx.grads) == 2 and len(g_tx.grads) == 1
    _compare_metrics(dict(metrics=got, jax_metrics=metrics))
    _compare_grads(dict(jax_old=({"params": g_params}, {"params": d_params}),
                        jax=new, trainer=trainer, g_tx=g_tx, d_tx=d_tx))
    for module, params in ((pd, new.d_params), (pg, new.g_params),
                           (trainer.g_ema, new.g_ema_params)):
        want = torch_state_dict(params)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **UPDATE_TOL, err_msg=name)


def _cli_run():
    from contrad_tpu_torch.train_gan import main

    return main(["configs/gan/cifar10/c10_b512.toml", "sndcgan",
                 "--mode", "contrad", "--aug", "simclr", "--use_warmup",
                 "--device", "cpu", "--print_every", "1", "--seed", "3",
                 "--override", "options.dataset=synthetic_8",
                 "options.batch_size=8", "options.max_steps=3"])


def test_three_cpu_steps_are_finite_and_reproducible():
    first, second = _cli_run(), _cli_run()
    assert [r["step"] for r in first] == [1, 2, 3]
    for a, b in zip(first, second):
        for k in ("D_loss", "D_penalty", "D_real", "D_gen", "G_loss"):
            assert np.isfinite(a[k]), k
            assert a[k] == b[k], k
    assert first[0]["D_loss"] != first[2]["D_loss"]  # it trains
    np.testing.assert_allclose(first[0]["G_loss"], np.log(2.0), **GRAD_TOL)
