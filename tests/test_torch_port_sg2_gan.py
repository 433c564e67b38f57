"""``train_gan`` on a StyleGAN2 architecture, as the JAX CLI runs it
(``train_gan.py:174`` hands any registry name to ``get_architecture``): the
port's ``GANTrainer`` with the ``stylegan2_tiny`` G and D against the JAX
package's ``GANTrainer._step`` for two consecutive steps, 8x8 images, batch
4, the ``std`` mode, float64 in both packages, on the same weights and the
same draws (each step's z, noise and style mixing, with G's default mixing
probability 0.9, reproduced from the state's key, which the first step
advances). Checked: both steps' losses and each step's update of every
parameter. Then the CLI itself, ``python -m contrad_tpu_torch.train_gan``
with ``stylegan2_tiny``, for two CPU steps: finite losses.

Tolerances: losses rtol 1e-3 / atol 1e-5, as in
``tests/test_torch_port_gan_step.py``. Updates by the rule of
``tests/test_torch_port_sg512_models.py`` for a gradient whose single
elements the leaky-ReLU kinks move (``ROADMAP.md`` §3): max|port - JAX|
within 1e-5 + 1e-3 max|JAX|, and at most 1 % of the elements off by over
1 %. JAX computes StyleGAN2's modulation in float32 even in a float64 run,
so the fakes differ at float32 rounding, and a pre-activation of D within
that of a kink moves its element of D's update by percents (one of 512
bias elements at 3.5 % here)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import GANTrainer as JaxTrainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.training import GANTrainer
from contrad_tpu_torch.training.modes import Draws
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_gan_step import GRAD_TOL, LR, RecordingSGD
from test_torch_port_sg512_models import assert_close_to_scale
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, noise_list, one_torch_thread, t, to_np)

N, SIZE = 4, 8


def jax_gan_draws(G, g_params, key, noise):
    """The draws of ``GANTrainer._step`` (step.py:201-275) with a StyleGAN2
    G, ``n_critic = 1``, no real augmentation, from the state's key."""
    variables = {"params": g_params}
    noise_t = [t(a) for a in noise]

    def g(z_rng, noise_rng):
        return {"z": t(G.sample_latent(z_rng, N)), "noise": noise_t,
                "mixing": jax_mixing(G, variables, noise_rng, N)}

    rng, z_rng, noise_rng, _, _ = jax.random.split(key, 5)  # _d_substep
    critic = [(g(z_rng, noise_rng), Draws())]
    _, z_rng, noise_rng, _, _, _ = jax.random.split(rng, 6)  # the G phase
    return StepDraws(None, critic, (g(z_rng, noise_rng), None))


def test_gan_trainer_runs_stylegan2_as_jax_does():
    _, _, g_params, d_params, pg, pd = build_pair("stylegan2_tiny", SIZE, 4)
    pg, pd = pg.double(), pd.double()
    img = (SIZE, SIZE, 3)
    noise = [a.astype(np.float64) for a in noise_list(pg, N, seed=31)]
    rng = np.random.default_rng(32)
    batches = [rng.uniform(size=(N,) + img) for _ in range(2)]
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    with jax.enable_x64(True):
        G, D = jax_get_architecture("stylegan2_tiny", img, dtype=jnp.float64)
        g_params, d_params = f64(g_params), f64(d_params)
        tx = optax.sgd(LR)
        jt = JaxTrainer(G, D, mode="std", augment_fn=jax_get_augment("simclr"),
                        g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                        g_kwargs={"noise": [jnp.asarray(a) for a in noise]})
        state = GANTrainState(
            step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(33),
            g_params=g_params, g_state={}, d_params=d_params, d_state={},
            g_opt_state=tx.init(g_params), d_opt_state=tx.init(d_params))
        step = jax.jit(jt._step)
        jax_metrics, draws, states = [], [], [to_np(state)]
        for images in batches:
            draws.append(jax_gan_draws(G, state.g_params, state.rng, noise))
            state, metrics = step(state, jnp.asarray(images))
            jax_metrics.append(to_np(metrics))
            states.append(to_np(state))

    trainer = GANTrainer(pg, pd, mode="std", augment=get_augment("simclr"),
                         g_optimizer=RecordingSGD(pg.parameters()),
                         d_optimizer=RecordingSGD(pd.parameters()),
                         loss_type="nonsat")
    for i, (images, step_draws, want) in enumerate(
            zip(batches, draws, jax_metrics)):
        before = [[p.detach().clone() for p in m.parameters()]
                  for m in (pd, pg)]
        got = trainer.train_step(t(images), draws=step_draws)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), **GRAD_TOL,
                                       err_msg=k)
        for module, old_p, old, new in (
                (pd, before[0], states[i].d_params, states[i + 1].d_params),
                (pg, before[1], states[i].g_params, states[i + 1].g_params)):
            want = torch_state_dict(jax.tree.map(lambda a, b: b - a, old, new))
            for (name, p), p0 in zip(module.named_parameters(), old_p):
                assert_close_to_scale(
                    (p.detach() - p0).numpy(), want[name].numpy(),
                    f"step {i + 1} {name}", frac=1e-3, share=0.01)


def test_train_gan_cli_runs_stylegan2_tiny(tmp_path):
    from contrad_tpu_torch.train_gan import main

    history = main(["configs/gan/cifar10/c10_b64.toml", "stylegan2_tiny",
                    "--mode", "contrad", "--aug", "simclr", "--device", "cpu",
                    "--print_every", "1", "--no_fid", "--no_gif",
                    "--logdir_root", str(tmp_path), "--override",
                    "options.dataset=synthetic_8_64", "options.batch_size=4",
                    "options.max_steps=2"])
    assert [r["step"] for r in history] == [1, 2]
    for rec in history:
        for k in ("D_loss", "D_penalty", "D_real", "D_gen", "G_loss"):
            assert np.isfinite(rec[k]), k
