"""One step of the 512x512 recipe's trainer in the port
(``StyleGAN2Trainer.train_step``, ``contrad`` with the ``simclr_hq`` chain
of ``afhq_dog_style64.toml``'s [augment] table and lazy R1,
``d_reg_every = 2``, ``lbd_r1 = 0.5``) against the JAX step built the way
the root ``train_stylegan2.py`` builds it for 512x512 (lines 203-231): G
emitting packed images, the augment chain packed, D taking them packed.
At 128x128 with ``channel_multiplier`` 0.25, where G and D both pack
(``tests/test_torch_port_sg512_models.py`` says why), batch 4, on the same
weights, noise and draws (z, style mixing and every augment draw,
reproduced from the JAX step's keys). This file runs the plain step;
``tests/test_torch_port_sg512_r1.py`` the step that carries R1.

Both packages' optimisers here keep the gradients they are given (the
JAX step's in its optimiser state, :func:`recording_tx`): read off float32
SGD updates, a gradient far smaller than its parameter (the style MLP's,
whose raw weights are 100 times their scale) would be lost in the
subtraction. Checked: every metric, G's and D's gradients, and the EMA of
G's pre-update parameters.

Float32 in both (JAX's float64 step at 128x128 runs for over 15 minutes on
the CPU): the leaky-ReLU kinks that the two programs' roundings flip move
single gradient elements (``tests/test_torch_port_sg512_models.py`` says
how, and holds the packed G and D element by element in float64). Each
gradient tensor is held to max|port - JAX| <= 1e-5 + 5e-3 max|JAX| with at
most 1 % of its elements off by over 1 % (``assert_close_to_scale``); the
largest seen here are 1.5e-3 of the max and 0.2 % (one element of G's
``layers.1.activate.bias``). Metrics rtol 1e-3 / atol 1e-5; the EMA rtol
1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import StyleGAN2Trainer as JaxTrainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.training import StyleGAN2Trainer
from contrad_tpu_torch.training.modes import Draws
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_gan_step import RecordingSGD
from test_torch_port_sg512_models import assert_close_to_scale
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, jax_simclr_params, noise_list, one_torch_thread,
    t, to_np)

METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
GRAD_TOL = dict(frac=5e-3, share=0.01)  # assert_close_to_scale's bounds
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
ARCH, SIZE, N, LBD_R1, D_REG_EVERY = "stylegan2_tiny", 128, 4, 0.5, 2
# afhq_dog_style64.toml's [augment] table, as the chain reads it
HQ = {"rrc": {"scale": (0.08, 1.0)},
      "color_jitter": {"brightness": 0.8, "contrast": 0.8, "saturation": 0.8,
                       "hue": 0.2},
      "cutout": {"length": 255}}


def recording_tx() -> optax.GradientTransformation:
    """An optax transformation whose state is the last gradients it was
    given, and which leaves the parameters as they are."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def run_step(do_r1: bool):
    """One step of both packages from the same state; returns what the
    comparisons need."""
    _, _, g_params, d_params, pg, pd = build_pair(ARCH, SIZE, seed=4)
    from contrad_tpu.models import get_architecture as jax_get_architecture

    G, D = jax_get_architecture(ARCH, (SIZE, SIZE, 3))
    pack = min(G.packed_io, D.backbone.packed_io)
    assert pack == 2
    rng = np.random.default_rng(20)
    noise = noise_list(G, N, seed=21)
    images = rng.uniform(size=(N, SIZE, SIZE, 3)).astype(np.float32)
    tx = recording_tx()
    jt = JaxTrainer(G, D, mode="contrad",
                    augment_fn=jax_get_augment("simclr_hq", HQ, pack=pack),
                    g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                    lbd_r1=LBD_R1, d_reg_every=D_REG_EVERY,
                    g_kwargs={"style_mix": 0.9,
                              "noise": [jnp.asarray(a) for a in noise]},
                    packed_images=pack)
    key = jax.random.PRNGKey(22)
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=key, g_params=g_params,
        g_state={}, d_params=d_params, d_state={},
        g_opt_state=tx.init(g_params), d_opt_state=tx.init(d_params),
        g_ema_params=g_params, g_ema_state={})
    new, metrics = jax.jit(jt._sg2_step, static_argnums=(3,))(
        state, jnp.asarray(images), 0.9, do_r1)

    # the draws of _sg2_step (step.py:476-492), in the port's form
    rng, z_rng, noise_rng, g_loss_rng = jax.random.split(key, 4)
    g_draws = {"z": t(G.sample_latent(z_rng, N)),
               "noise": [t(a) for a in noise],
               "mixing": jax_mixing(G, {"params": g_params}, noise_rng, N)}
    g_aug = jax_simclr_params(g_loss_rng, N, SIZE, SIZE, "simclr_hq", HQ)
    rng, d_loss_rng, r1_rng = jax.random.split(rng, 3)
    d_aug = jax_simclr_params(d_loss_rng, 3 * N, SIZE, SIZE, "simclr_hq", HQ)
    r1_aug = (jax_simclr_params(r1_rng, N, SIZE, SIZE, "simclr_hq", HQ)
              if do_r1 else None)
    draws = StepDraws(None, [(None, Draws(d_aug))], (g_draws, g_aug), r1_aug)

    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = StyleGAN2Trainer(
        pg, pd, mode="contrad", augment=get_augment("simclr_hq", HQ),
        g_optimizer=g_tx, d_optimizer=d_tx, loss_type="nonsat",
        lbd_r1=LBD_R1, d_reg_every=D_REG_EVERY)
    got = trainer.train_step(t(images), ema_decay=0.9, draws=draws)
    return dict(jax=to_np(new),
                jax_metrics=to_np(metrics), metrics=got, trainer=trainer,
                g_tx=g_tx, d_tx=d_tx)


def check_step(r, do_r1: bool):
    assert set(r["metrics"]) == set(r["jax_metrics"])
    for k, v in r["jax_metrics"].items():
        np.testing.assert_allclose(float(r["metrics"][k]), float(v),
                                   **METRIC_TOL, err_msg=k)
    assert (float(r["metrics"]["D_r1"]) > 0) == do_r1
    new, trainer = r["jax"], r["trainer"]
    for tx, jax_grads, module in (
            (r["d_tx"], new.d_opt_state, trainer.discriminator),
            (r["g_tx"], new.g_opt_state, trainer.generator)):
        want = torch_state_dict(jax_grads)
        names = [k for k, _ in module.named_parameters()]
        assert set(names) == set(want) and len(tx.grads) == 1
        for name, g in zip(names, tx.grads[0], strict=True):
            assert_close_to_scale(g.numpy(), want[name].numpy(), name,
                                  **GRAD_TOL)
    want = torch_state_dict(new.g_ema_params)
    for name, p in trainer.g_ema.named_parameters():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **UPDATE_TOL,
                                   err_msg=name)


def test_plain_step_matches_jax_packed():
    check_step(run_step(do_r1=False), do_r1=False)
