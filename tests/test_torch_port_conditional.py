"""The port's class-conditional discriminator and trainer step
(``contrad_tpu_torch/ops/spectral_norm.py::SNEmbed``, the ``linear_y``
projection of ``models/base.py``, labels through ``training/modes.py``,
``penalty.py`` and ``step.py``) against the JAX package's, on the same
SNDCGAN weights and state (16x16, ngf = ndf = 16, nz = 32, d_hidden = 64,
10 classes, batch 4, float64 in both packages, as
``tests/test_torch_port_sndcgan.py`` explains) and the same draws:
latents, augmentations, penalty draws and the fakes' labels, reproduced
from the JAX step's keys.

Checked (here and in ``tests/test_torch_port_conditional_penalty.py``,
which takes the penalties' cases): ``SNEmbed`` and ``Discriminator(x, y)`` forward, the gradients of
the score in the weights and the input, and ``u`` after a persisting pass;
a conditional ``GANTrainer`` step for ``contrad`` and ``std``, the latter
under each penalty ``gp``, ``cr`` and ``bcr``: losses, gradients (read off
SGD updates), ``u`` (``linear_y``'s included) and G's batch-norm
statistics. Tolerances: forwards and state rtol 1e-4 / atol 1e-6; losses
and gradients rtol 1e-3 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models.sndcgan import DSndcgan as JaxD
from contrad_tpu.models.sndcgan import GSndcgan as JaxG
from contrad_tpu.ops.spectral_norm import SNEmbed as JaxSNEmbed
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import GANTrainer as JaxTrainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan
from contrad_tpu_torch.ops.spectral_norm import SNEmbed, commit_u
from contrad_tpu_torch.training import GANTrainer
from test_torch_port_gan_step import (
    LR, RecordingSGD, _compare_grads, _compare_metrics, _compare_state,
    jax_step_draws)
from test_torch_port_sndcgan import D_HIDDEN, IMG, N, NDF, NGF, NZ, _f64
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    jax_fake_labels, one_torch_thread, t, to_np)

TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
N_CLASSES = 10


@pytest.fixture(scope="module")
def pair():
    """The conditional JAX G and D (float64) with their variables, and a
    function that makes the port's twins in double with the same state."""
    with jax.enable_x64(True):
        G = JaxG(IMG, ngf=NGF, nz=NZ, dtype=jnp.float64)
        D = JaxD(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN,
                 dtype=jnp.float64, n_classes=N_CLASSES)
        kg, kd = jax.random.split(jax.random.PRNGKey(3))
        g_vars = jax.jit(lambda k: G.init(k, jnp.zeros((2, NZ)),
                                          train=True))(kg)
        d_vars = jax.jit(lambda k: D.init(
            k, jnp.zeros((2,) + IMG), y=jnp.zeros((2,), jnp.int32),
            train=True))(kd)
    g_vars = {"params": _f64(g_vars["params"]),
              "batch_stats": _f64(g_vars["batch_stats"])}
    d_vars = {"params": _f64(d_vars["params"]),
              "spectral": to_np(d_vars["spectral"])}

    def port():
        pg = GSndcgan(IMG, ngf=NGF, nz=NZ).double()
        pd = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN,
                      n_classes=N_CLASSES).double()
        pg.load_state_dict(torch_state_dict(
            g_vars["params"], {"batch_stats": g_vars["batch_stats"]}),
            strict=True)
        pd.load_state_dict(torch_state_dict(
            d_vars["params"], {"spectral": d_vars["spectral"]}), strict=True)
        return pg, pd

    return G, D, g_vars, d_vars, port


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_snembed_matches_jax(train):
    y = np.array([3, 0, 9, 3, 5])
    with jax.enable_x64(True):
        m = JaxSNEmbed(N_CLASSES, 6)
        v = m.init(jax.random.PRNGKey(0), jnp.asarray(y))
        v = {"params": _f64(v["params"]), "spectral": to_np(v["spectral"])}
        want, new = m.apply(v, jnp.asarray(y), train=train,
                            mutable=["spectral"])
    port = SNEmbed(N_CLASSES, 6).double()
    port.load_state_dict(torch_state_dict(v["params"],
                                          {"spectral": v["spectral"]}))
    with torch.no_grad():
        got = port(torch.from_numpy(y), train=train)
    commit_u(port)
    _close(got.numpy(), want, "embedding")
    _close(port.u.numpy(), new["spectral"]["u"], "u")
    assert port.u.shape == (N_CLASSES,)


def test_conditional_discriminator_forward_grads_and_u_match_jax(pair):
    _, D, _, d_vars, port = pair
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(N,) + IMG)
    y = rng.integers(0, N_CLASSES, size=N)
    with jax.enable_x64(True):
        def score(params, x):
            (d, aux), new = D.apply({"params": params,
                                     "spectral": d_vars["spectral"]}, x,
                                    y=jnp.asarray(y), train=True,
                                    mutable=["spectral"])
            return jnp.sum(d), (d, new)

        (_, (d, new)), (g_params, g_x) = jax.jit(jax.value_and_grad(
            score, argnums=(0, 1), has_aux=True))(d_vars["params"],
                                                  jnp.asarray(x))
        # without labels, eval mode, from the u the pass above persisted
        d_uncond, _ = jax.jit(lambda v, x: D.apply(v, x, train=False))(
            {"params": d_vars["params"], **new}, jnp.asarray(x))
    _, pd = port()
    xt = t(x).requires_grad_(True)
    got, _ = pd(xt, y=torch.from_numpy(y))
    grads = torch.autograd.grad(got.sum(), [xt] + list(pd.parameters()),
                                allow_unused=True, materialize_grads=True)
    commit_u(pd)
    _close(got.detach().numpy(), d, "score")
    _close(grads[0].numpy(), g_x, "d score / d x", GRAD_TOL)
    want = torch_state_dict(g_params)
    for (name, _), g in zip(pd.named_parameters(), grads[1:]):
        _close(g.numpy(), want[name].numpy(), name, GRAD_TOL)
    have = pd.state_dict()
    for name, u in torch_state_dict({}, new).items():
        _close(have[name].numpy(), u.numpy(), name)
    assert "linear.linear_y.u" in have and "linear.linear_y.weight" in have
    # no labels: the unconditional score (eval mode)
    with torch.no_grad():
        plain, _ = pd(t(x), train=False)
    _close(plain.numpy(), d_uncond, "score without labels")


def run_conditional(pair, mode, penalty):
    """One conditional ``train_gan.py`` step of both packages (SGD at
    ``LR``) on the pair's state, the same images, labels and draws."""
    G, D, g_vars, d_vars, port = pair
    rng = np.random.default_rng(7)
    images = rng.uniform(size=(N,) + IMG)
    labels = rng.integers(0, N_CLASSES, size=N)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        tx = optax.sgd(LR)
        jt = JaxTrainer(G, D, mode=mode, augment_fn=jax_get_augment("simclr"),
                        g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                        penalty=penalty)
        state = GANTrainState(
            step=jnp.zeros((), jnp.int32), rng=key,
            g_params=g_vars["params"],
            g_state={"batch_stats": g_vars["batch_stats"]},
            d_params=d_vars["params"], d_state={"spectral": d_vars["spectral"]},
            g_opt_state=tx.init(g_vars["params"]),
            d_opt_state=tx.init(d_vars["params"]),
            g_ema_params=None, g_ema_state=None)
        new, metrics = jax.jit(jt._step)(state, jnp.asarray(images), 0.0,
                                         jnp.asarray(labels))
        draws = jax_step_draws(mode, penalty, key, N, 1, False)
        y_gen = jax_fake_labels(key, N, 1, N_CLASSES)
    pg, pd = port()
    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = GANTrainer(pg, pd, mode=mode, augment=get_augment("simclr"),
                         g_optimizer=g_tx, d_optimizer=d_tx,
                         loss_type="nonsat", penalty=penalty)
    assert trainer.conditional
    got = trainer.train_step(t(images), draws=draws._replace(y_gen=y_gen),
                             labels=torch.from_numpy(labels))
    return dict(jax_old=(g_vars, d_vars), jax=to_np(new),
                jax_metrics=to_np(metrics), trainer=trainer, metrics=got,
                g_tx=g_tx, d_tx=d_tx)


def check_step(pair, mode, penalty):
    r = run_conditional(pair, mode, penalty)
    if penalty != "none":
        assert float(r["metrics"]["D_penalty"]) > 0
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)
    # the class table learned in the D phase
    names = [k for k, _ in r["trainer"].discriminator.named_parameters()]
    grad = r["d_tx"].grads[0][names.index("linear.linear_y.weight")]
    assert grad.abs().max() > 0


# one parametrised test, its cases split between this file and
# test_torch_port_conditional_penalty.py (the test workers run a file each)
@pytest.mark.parametrize("mode,penalty", [
    ("contrad", "none"), ("std", "none")])
def test_conditional_step_matches_jax(pair, mode, penalty):
    check_step(pair, mode, penalty)


def test_conditional_step_needs_labels_and_unconditional_ignores_them(pair):
    *_, port = pair
    pg, pd = port()
    trainer = GANTrainer(pg, pd, mode="std", augment=get_augment("none"),
                         g_optimizer=RecordingSGD(pg.parameters()),
                         d_optimizer=RecordingSGD(pd.parameters()),
                         loss_type="nonsat")
    with pytest.raises(ValueError, match="pass labels"):
        trainer.train_step(torch.rand(N, *IMG, dtype=torch.float64))
    with pytest.raises(ValueError, match="unconditional head"):
        DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN)(
            torch.rand(2, *IMG), y=torch.zeros(2, dtype=torch.long))
    pg = GSndcgan(IMG, ngf=NGF, nz=NZ)
    pd = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN)
    trainer = GANTrainer(pg, pd, mode="std", augment=get_augment("none"),
                         g_optimizer=RecordingSGD(pg.parameters()),
                         d_optimizer=RecordingSGD(pd.parameters()),
                         loss_type="nonsat")
    images = torch.rand(N, *IMG)
    draws = trainer.draw_step(images.shape)
    assert draws.y_gen is None
    a = trainer.train_step(images, draws=draws,
                           labels=torch.zeros(N, dtype=torch.long))
    assert all(torch.isfinite(v) for v in a.values())


def test_bcr_takes_both_label_sets_or_neither():
    from contrad_tpu_torch.training.modes import ModeCtx
    from contrad_tpu_torch.training.penalty import compute_penalty

    ctx = ModeCtx(get_augment("none"), "nonsat", penalty="bcr")
    x = torch.rand(2, *IMG)
    with pytest.raises(ValueError, match="both"):
        compute_penalty(ctx, None, images=x, gen_images=x,
                        all_images=torch.cat([x, x]), d_real=x[:, 0, 0, :1],
                        d_gen=x[:, 0, 0, :1], params=None,
                        y_real=torch.zeros(2, dtype=torch.long))
