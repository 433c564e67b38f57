"""The port's ``GANTrainer.train_step`` (``contrad_tpu_torch/training``)
against ``contrad_tpu``'s ``GANTrainer._step``, the ``train_gan.py`` step,
on the same SNDCGAN weights and state (``tests/test_torch_port_sndcgan.py``
builds the pair: 16x16, ngf = ndf = 16, nz = 32, d_hidden = 64, batch 4,
float64 in both packages) and the same draws: the latents, the mode's
augmentation parameters, the penalty's draws and the real images' flip,
reproduced from the JAX step's keys (``jax_step_draws``).

Checked, per case: the D sub-steps' and the G phase's losses (the metrics);
both phases' gradients; the parameters after the updates; spectral norm's
``u`` (which advances in the D phase and again in the G phase) and G's
batch-norm statistics (which move in the D phase's and in the G phase's G
forward) after the step. Cases here: ``contrad`` with Adam and warmup
(the flagship); ``std`` with each GAN loss; ``n_critic = 2`` with the real
images' flip and the post-update EMA. ``tests/test_torch_port_gan_modes.py``
holds the penalties, the other modes, the StyleGAN2 trainer's
``n_critic = 2`` and the new CLI.

Gradients: both packages train with plain SGD at rate ``LR`` here (the
port's through a recording stand-in optimiser), so the JAX step's gradients
are ``(before - after) / LR``, read off the state it returns; with
``n_critic = 2`` the sum of the two D sub-steps' gradients is compared.
The Adam case compares the parameters after the updates.

Tolerances: forwards and state rtol 1e-4 / atol 1e-6; losses and gradients
rtol 1e-3 / atol 1e-5; parameters after SGD or Adam updates rtol 1e-5 /
atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.training.state import GANTrainState, make_optimizer
from contrad_tpu.training.step import GANTrainer as JaxTrainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.training import GANTrainer, ScheduledAdam
from contrad_tpu_torch.training.modes import Draws
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_sndcgan import IMG, N, NZ, build_sndcgan_pair
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    jax_flip_params, jax_simclr_params, one_torch_thread, t, to_np)

STATE_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-2
G_AUG = ("aug_both", "simclr_only", "contrad")


@pytest.fixture(scope="module")
def pair():
    return build_sndcgan_pair(seed=1)


class RecordingSGD:
    """``p -= LR * g``, keeping every gradient list it was given."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = []

    @torch.no_grad()
    def step(self, grads):
        self.grads.append([g.detach().clone() for g in grads])
        for p, g in zip(self.params, grads, strict=True):
            p.sub_(LR * g)


def jax_d_draws(mode, penalty, key, n, img=IMG):
    """The D loss's draws that ``contrad_tpu/training/modes.py`` makes from
    ``key`` (``_std_loss_D`` and the others), in the port's form."""
    h, w = img[:2]
    aug, pen_key = None, key
    if mode in ("aug", "aug_both"):
        rng_aug, pen_key = jax.random.split(key)
        aug = jax_simclr_params(rng_aug, n * (1 if mode == "aug" else 2), h, w)
    elif mode in ("simclr_only", "contrad"):
        aug = jax_simclr_params(key, n * (2 if mode == "simclr_only" else 3),
                                h, w)
        return Draws(aug, None)  # these modes take no penalty
    pen = None
    if penalty == "gp":  # penalty.py:28
        pen = t(jax.random.uniform(pen_key, (n, 1, 1, 1)).reshape(n))
    elif penalty == "cr":
        pen = jax_simclr_params(pen_key, n, h, w)
    elif penalty == "bcr":
        pen = jax_simclr_params(pen_key, 2 * n, h, w)
    return Draws(aug, pen)


def jax_step_draws(mode, penalty, key, n, n_critic, real_flip, img=IMG,
                   nz=NZ):
    """Every draw of ``GANTrainer._step`` (step.py:238-275) from the state's
    key, in the port's :class:`StepDraws` form (under ``enable_x64``)."""
    rng, real = key, None
    if real_flip:
        rng, ra_rng = jax.random.split(rng)
        real = jax_flip_params(ra_rng, n_critic * n)
    critic = []
    for _ in range(n_critic):  # _d_substep
        rng, z_rng, _, loss_rng, _ = jax.random.split(rng, 5)
        z = jax.random.uniform(z_rng, (n, nz), minval=-1.0, maxval=1.0)
        critic.append(({"z": t(z)}, jax_d_draws(mode, penalty, loss_rng, n,
                                                img)))
    rng, z_rng, _, g_loss_rng, _, _ = jax.random.split(rng, 6)
    z = jax.random.uniform(z_rng, (n, nz), minval=-1.0, maxval=1.0)
    g_aug = (jax_simclr_params(g_loss_rng, n, *img[:2]) if mode in G_AUG
             else None)
    return StepDraws(real, critic, ({"z": t(z)}, g_aug))


def run_case(pair, mode, penalty="none", loss="nonsat", n_critic=1,
             adam=False, real_flip=False, ema=False, n=N):
    """One ``train_gan.py`` step of both packages on the pair's weights and
    state (a pair as ``build_sndcgan_pair`` makes it, of any image size
    and D) with the same draws, at batch ``n``."""
    G, D, g_vars, d_vars, port = pair
    img = tuple(G.image_size)
    images = np.random.default_rng(7).uniform(size=(n_critic * n,) + img)
    with jax.enable_x64(True):
        tx = (make_optimizer(2e-4, (0.5, 0.999), warmup=10, use_warmup=True)
              if adam else optax.sgd(LR))
        jt = JaxTrainer(G, D, mode=mode, augment_fn=jax_get_augment("simclr"),
                        g_optimizer=tx, d_optimizer=tx, loss_type=loss,
                        penalty=penalty, n_critic=n_critic, ema=ema,
                        real_aug_fn=(jax_get_augment("hflip") if real_flip
                                     else None))
        g_state = {"batch_stats": g_vars["batch_stats"]}
        key = jax.random.PRNGKey(9)
        state = GANTrainState(
            step=jnp.zeros((), jnp.int32), rng=key,
            g_params=g_vars["params"], g_state=g_state,
            d_params=d_vars["params"], d_state={"spectral": d_vars["spectral"]},
            g_opt_state=tx.init(g_vars["params"]),
            d_opt_state=tx.init(d_vars["params"]),
            g_ema_params=g_vars["params"] if ema else None,
            g_ema_state=g_state if ema else None)
        new, metrics = jax.jit(jt._step)(state, jnp.asarray(images), 0.9)
        draws = jax_step_draws(mode, penalty, key, n, n_critic, real_flip,
                               img, G.nz)
    new, metrics = to_np(new), to_np(metrics)

    pg, pd = port()
    if adam:
        g_tx = ScheduledAdam(pg.parameters(), 2e-4, (0.5, 0.999), warmup=10,
                             use_warmup=True)
        d_tx = ScheduledAdam(pd.parameters(), 2e-4, (0.5, 0.999), warmup=10,
                             use_warmup=True)
    else:
        g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = GANTrainer(
        pg, pd, mode=mode, augment=get_augment("simclr"), g_optimizer=g_tx,
        d_optimizer=d_tx, loss_type=loss, penalty=penalty, n_critic=n_critic,
        ema=ema, real_augment=get_augment("hflip") if real_flip else None)
    got = trainer.train_step(t(images), ema_decay=0.9, draws=draws)
    return dict(jax_old=(g_vars, d_vars), jax=new, jax_metrics=metrics,
                trainer=trainer, metrics=got, g_tx=g_tx, d_tx=d_tx)


def _compare_metrics(r):
    assert set(r["metrics"]) == set(r["jax_metrics"])
    for k, v in r["jax_metrics"].items():
        np.testing.assert_allclose(float(r["metrics"][k]), float(v),
                                   **GRAD_TOL, err_msg=k)


def _compare_module(module, params, state, tol, what):
    want = torch_state_dict(params, state)
    have = module.state_dict()
    assert want and set(want) <= set(have), what
    for name, w in want.items():
        np.testing.assert_allclose(have[name].numpy(), w.numpy(), **tol,
                                   err_msg=f"{what}: {name}")


def _compare_state(r):
    """u and the batch-norm statistics after the step, and the parameters
    after the updates."""
    trainer, new = r["trainer"], r["jax"]
    _compare_module(trainer.discriminator, {}, new.d_state, STATE_TOL, "D u")
    _compare_module(trainer.generator, {}, new.g_state, STATE_TOL, "G stats")
    for module, params, what in ((trainer.discriminator, new.d_params, "D"),
                                 (trainer.generator, new.g_params, "G")):
        want = torch_state_dict(params)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **UPDATE_TOL, err_msg=f"{what}: {name}")


def _compare_grads(r):
    """The port's gradients (summed over the D sub-steps) against the JAX
    step's, read off its SGD updates."""
    (g_old, d_old), new = r["jax_old"], r["jax"]
    for tx, old, params, module in (
            (r["d_tx"], d_old["params"], new.d_params, r["trainer"].discriminator),
            (r["g_tx"], g_old["params"], new.g_params, r["trainer"].generator)):
        want = torch_state_dict(jax.tree.map(lambda a, b: (a - b) / LR, old,
                                             params))
        names = [k for k, _ in module.named_parameters()]
        summed = [sum(gs) for gs in zip(*tx.grads)]
        for name, g in zip(names, summed, strict=True):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       **GRAD_TOL, err_msg=name)


def test_contrad_step_with_adam_and_warmup_matches_jax(pair):
    """The flagship: contrad, simclr, nonsat, Adam with warmup."""
    r = run_case(pair, "contrad", adam=True)
    _compare_metrics(r)
    _compare_state(r)


@pytest.mark.parametrize("loss", ["nonsat", "wgan", "hinge", "lsgan"])
def test_std_step_matches_jax_for_each_gan_loss(pair, loss):
    r = run_case(pair, "std", loss=loss)
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)


def test_two_critic_steps_with_flip_and_ema_match_jax(pair):
    """n_critic = 2: two D sub-steps on fresh halves of the batch and fresh
    fakes (u and the batch-norm statistics advance in each), the flip of
    the real images, and the EMA of G after its update (buffers copied)."""
    r = run_case(pair, "contrad", n_critic=2, real_flip=True, ema=True)
    assert len(r["d_tx"].grads) == 2 and len(r["g_tx"].grads) == 1
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)
    new = r["jax"]
    _compare_module(r["trainer"].g_ema, new.g_ema_params, new.g_ema_state,
                    UPDATE_TOL, "G EMA")


def test_aug_both_refuses_lsgan(pair):
    *_, port = pair
    pg, pd = port()
    trainer = GANTrainer(pg, pd, mode="aug_both", augment=get_augment("simclr"),
                         g_optimizer=RecordingSGD(pg.parameters()),
                         d_optimizer=RecordingSGD(pd.parameters()),
                         loss_type="lsgan")
    with pytest.raises(NotImplementedError, match="lsgan"):
        trainer.train_step(torch.rand(N, *IMG, dtype=torch.float64))
