"""The whole slice: the port's StyleGAN2 + ContraD train step
(``contrad_tpu_torch/training``) against ``contrad_tpu``'s
``StyleGAN2Trainer`` on the same weights, z, noise, style-mixing draws and
augmentation draws (``tests/torch_port_jax.py`` reproduces them from the JAX
keys), at the ``stylegan2_tiny`` width on 8x8 images, batch 4 (the D pass
takes 3 x 4 images, which minibatch stddev groups by 4).

Checked: the G-phase loss and G gradients; the D-phase loss with R1 (a
gradient of a gradient through the blur) and the D gradients; two Adam
updates with warmup and an EMA update on those gradients; and three port
steps through the CLI, finite and the same twice from one seed.

The comparison of the two phases runs both packages in float64 (JAX under
``jax.enable_x64``, its models with a float64 compute dtype; the port's
modules in double). In float32 the two programs round differently, and a
pre-activation within rounding of a leaky-ReLU kink then takes the other
slope in one of them: the gradient is discontinuous there, and one such
element moves a bias gradient by percents. In float64 the rounding is far
below any pre-activation. Where the JAX package computes in float32 on
purpose (the heads' inputs, the losses), it still does.

Tolerances: losses and gradients rtol 1e-3 / atol 1e-5 (sums in other
orders through two backward passes, and the float32 steps above); optimiser
and EMA updates on the same gradients rtol 1e-5 / atol 1e-6 (elementwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu.training.state import ema_update as jax_ema_update
from contrad_tpu.training.state import make_optimizer
from contrad_tpu.training.step import StyleGAN2Trainer as JaxTrainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.training import ScheduledAdam, StyleGAN2Trainer, ema_update
from contrad_tpu_torch.training.modes import Draws
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, jax_simclr_params, noise_list, one_torch_thread, t,
    to_np)

GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
N, SIZE, LBD_R1 = 4, 8, 0.1


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def slice_run():
    _, _, g_params, d_params, pg, pd = build_pair("stylegan2_tiny", SIZE, 1)
    pg, pd = pg.double(), pd.double()
    rng = np.random.default_rng(10)
    z = rng.normal(size=(N, pg.style_dim))
    noise = [a.astype(np.float64) for a in noise_list(pg, N, seed=11)]
    images = rng.uniform(size=(N, SIZE, SIZE, 3))

    with jax.enable_x64(True):
        G, D = jax_get_architecture("stylegan2_tiny", (SIZE, SIZE, 3),
                                    dtype=jnp.float64)
        g_params, d_params = _f64(g_params), _f64(d_params)
        k_noise, k_g_aug, k_d_aug, k_r1 = jax.random.split(
            jax.random.PRNGKey(12), 4)
        opt = make_optimizer(2e-3, (0.0, 0.99), warmup=10, use_warmup=True)
        jt = JaxTrainer(G, D, mode="contrad",
                        augment_fn=jax_get_augment("simclr"),
                        g_optimizer=opt, d_optimizer=opt, loss_type="nonsat",
                        lbd_r1=LBD_R1, d_reg_every=1,
                        g_kwargs={"style_mix": 0.9,
                                  "noise": [jnp.asarray(a) for a in noise]})

        # jitted, with the arrays as arguments rather than constants: XLA
        # would otherwise spend its time folding the weights into the graph
        def g_loss_fn(p, dp, z):  # StyleGAN2Trainer._g_update's loss
            gen, _ = jt._g_apply_train(p, {}, z, train=True, rng=k_noise,
                                       **jt.g_kwargs)
            loss, _ = jt.loss_G(jt.ctx, dp, {}, gen, k_g_aug)
            return loss, gen

        (g_loss, gen), g_grads = jax.jit(jax.value_and_grad(
            g_loss_fn, has_aux=True))(g_params, d_params, jnp.asarray(z))

        def d_loss_fn(p, images, gen):  # _sg2_step's d_loss_fn, with R1
            total, (metrics, _) = jt.loss_D(jt.ctx, p, {}, images, gen,
                                            k_d_aug)
            r1 = jt._r1(p, {}, images, k_r1)
            return total + 0.5 * LBD_R1 * r1, dict(metrics, D_r1=r1)

        (d_total, d_metrics), d_grads = jax.jit(jax.value_and_grad(
            d_loss_fn, has_aux=True))(d_params, jnp.asarray(images), gen)
        mixing = jax_mixing(G, {"params": g_params}, k_noise, N)
        g_aug = jax_simclr_params(k_g_aug, N, SIZE, SIZE)
        d_aug = jax_simclr_params(k_d_aug, 3 * N, SIZE, SIZE)
        r1_aug = jax_simclr_params(k_r1, N, SIZE, SIZE)

    trainer = StyleGAN2Trainer(
        pg, pd, mode="contrad", augment=get_augment("simclr"),
        g_optimizer=ScheduledAdam(pg.parameters(), 2e-3, (0.0, 0.99)),
        d_optimizer=ScheduledAdam(pd.parameters(), 2e-3, (0.0, 0.99)),
        loss_type="nonsat", lbd_r1=LBD_R1, d_reg_every=1)
    p_g_loss, p_gen = trainer.g_loss(t(z), [t(a) for a in noise], mixing,
                                     g_aug)
    p_g_grads = dict(zip([k for k, _ in pg.named_parameters()],
                         torch.autograd.grad(p_g_loss, list(pg.parameters()))))
    p_total, p_metrics = trainer.d_loss(t(images), t(gen), Draws(d_aug), r1_aug)
    p_d_grads = dict(zip([k for k, _ in pd.named_parameters()],
                         torch.autograd.grad(p_total, list(pd.parameters()))))
    return dict(
        jax=dict(g_loss=g_loss, gen=gen, g_grads=g_grads, d_total=d_total,
                 d_metrics=d_metrics, d_grads=d_grads, g_params=g_params,
                 opt=opt),
        port=dict(g_loss=p_g_loss.detach(), gen=p_gen.detach(),
                  g_grads=p_g_grads, d_total=p_total.detach(),
                  d_metrics={k: v.detach() for k, v in p_metrics.items()},
                  d_grads=p_d_grads, G=pg))


def _assert_grads(port_grads, jax_grads):
    want = torch_state_dict(to_np(jax_grads))
    assert set(port_grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(port_grads[name].numpy(), w.numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_g_phase_loss_fakes_and_grads_match_jax(slice_run):
    j, p = slice_run["jax"], slice_run["port"]
    np.testing.assert_allclose(p["gen"].numpy(), np.asarray(j["gen"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(p["g_loss"]), float(j["g_loss"]),
                               **GRAD_TOL)
    _assert_grads(p["g_grads"], j["g_grads"])


def test_d_phase_loss_with_r1_and_grads_match_jax(slice_run):
    j, p = slice_run["jax"], slice_run["port"]
    np.testing.assert_allclose(float(p["d_total"]), float(j["d_total"]),
                               **GRAD_TOL)
    assert float(j["d_metrics"]["D_r1"]) > 0
    for k, v in j["d_metrics"].items():
        np.testing.assert_allclose(float(p["d_metrics"][k]), float(v),
                                   **GRAD_TOL, err_msg=k)
    _assert_grads(p["d_grads"], j["d_grads"])


def test_adam_warmup_and_ema_updates_match_jax(slice_run):
    j, p = slice_run["jax"], slice_run["port"]
    G = p["G"]
    names = [k for k, _ in G.named_parameters()]
    grads = torch_state_dict(to_np(j["g_grads"]))
    ema = {k: v.detach().clone() for k, v in G.named_parameters()}

    opt = ScheduledAdam(G.parameters(), 2e-3, (0.0, 0.99), warmup=10,
                        use_warmup=True)
    with jax.enable_x64(True):
        params, opt_state = j["g_params"], j["opt"].init(j["g_params"])
        for scale in (1.0, -0.5):  # two updates: warmup lr 2e-4, then 4e-4
            g_scaled = jax.tree.map(lambda g: g * scale, j["g_grads"])
            updates, opt_state = j["opt"].update(g_scaled, opt_state, params)
            params = optax.apply_updates(params, updates)
            opt.step([grads[k].double() * scale for k in names])
        ema_tree = jax_ema_update(j["g_params"], params, 0.9)
    want = torch_state_dict(to_np(params))
    for name, v in G.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), want[name].numpy(),
                                   **UPDATE_TOL, err_msg=name)

    # EMA of the pre-update parameters toward the updated ones
    module = type(G).__new__(type(G))
    torch.nn.Module.__init__(module)
    for k, v in ema.items():  # a flat stand-in module holding the EMA copy
        module.register_parameter(k.replace(".", "__"), torch.nn.Parameter(v))
    ema_update(module, G, 0.9)
    want = torch_state_dict(to_np(ema_tree))
    for k in names:
        np.testing.assert_allclose(
            getattr(module, k.replace(".", "__")).detach().numpy(),
            want[k].numpy(), **UPDATE_TOL, err_msg=k)


def _cli_run():
    from contrad_tpu_torch.train_stylegan2 import main

    return main(["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
                 "--mode", "contrad", "--aug", "simclr", "--lbd_r1", "0.1",
                 "--no_lazy", "--halflife_k", "1000", "--ema_start_k", "0",
                 "--use_warmup", "--device", "cpu", "--print_every", "1",
                 "--seed", "3", "--override", "options.dataset=synthetic_8",
                 "options.batch_size=4", "options.max_steps=3"])


def test_three_cpu_steps_are_finite_and_reproducible():
    first, second = _cli_run(), _cli_run()
    assert [r["step"] for r in first] == [1, 2, 3]
    for a, b in zip(first, second):
        for k in ("D_loss", "D_penalty", "D_real", "D_gen", "D_r1", "G_loss"):
            assert np.isfinite(a[k]), k
            assert a[k] == b[k], k
        assert a["D_r1"] > 0
