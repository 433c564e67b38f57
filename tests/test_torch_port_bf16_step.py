"""The bfloat16 train steps and CLIs of the port against the JAX package's
(``--dtype bf16``): the models built with a bfloat16 compute dtype in both
packages, float32 parameters from the same JAX init (through
``contrad_tpu_torch/bridge.py``), the same images from a numpy seed and the
same draws, reproduced from the JAX step's keys.

* the flagship's ``contrad`` ``GANTrainer`` step (SNDCGAN at 16x16, ngf =
  ndf = 16, nz = 32, d_hidden = 64, batch 4) against ``GANTrainer._step``;
* a ``StyleGAN2Trainer`` step with R1 (``stylegan2_tiny`` at 8x8, batch 4,
  ``contrad``, ``lbd_r1`` 0.1) against ``StyleGAN2Trainer._sg2_step``;
* the dtype audit at JAX's cast points in both steps: the images entering
  the augment chain bfloat16, the projections reaching the contrastive
  losses float32, spectral norm's ``u`` and every parameter float32 after
  the step (the stored Adam moments are audited against optax in
  ``tests/test_torch_port_opt_levers.py`` and in the CLI runs below);
* the three train CLIs with the production stack ``--dtype bf16
  --opt_moments bf16 --opt_nu bf16 --opt_grads bf16`` for 2 steps on the
  CPU: finite losses, bfloat16 moments in the checkpoint and float32
  parameters, ``--resume`` after step 1 bitwise equal to the uninterrupted
  run, the StyleGAN2 run's in-loop FID (``moments``) and progress GIF made
  from its bfloat16 EMA G in eval mode (float32 images), and the evaluation
  CLIs loading the run's float32 parameters as they are.

Both packages train with plain SGD (the port's through a recording
stand-in), so the JAX step's gradients are read off the state it returns:
the flagship's D at rate ``LR`` (its G phase reads the updated D), every
other update at ``READ_LR``, so large that ``old - new`` keeps the
gradient's digits next to the StyleGAN2 style MLP's raw weights (N(0,
100)).

Tolerances: losses ``|port - jax| <= 3e-2 * |jax|``; spectral norm's
``u`` after the step ``3e-2 * max|jax|``, or twice JAX's own
bfloat16-against-float32 difference where that is larger (the first
conv's ``u`` after the D update: 0.074 in JAX, 0.064 between the
packages, on a maximum of 0.54).

Gradients: per parameter tensor, the cosine similarity of the port's
gradient against JAX's bfloat16 one is at least 0.99 (a bfloat16
activation flips a leaky-ReLU kink more often than a float32 one), or,
where JAX's own bfloat16 gradient is further than that from its float32
one, at least the cosine of those two: the port's bfloat16 gradient is no
further from JAX's than JAX's float32 gradient is. That is the SNDCGAN G at
initialisation, whose gradients reach G through seven bfloat16 convs of D
and four batch norms (JAX's bfloat16 against its float32: 0.84-0.98; the
port's against JAX's bfloat16: 0.91-0.99, above the bound in every tensor),
and three of the StyleGAN2 D's head tensors. A control shows the rule can
fail: the same step with the port's G in float32 (D in bfloat16) gives G
gradients about as close to JAX's bfloat16 as JAX's float32 ones (0.80
against a bound of 0.84 for the dense layer) and is refused. A single layer
computing in float32 moves the gradients less than bfloat16's own noise;
``tests/test_torch_port_bf16_models.py`` refuses it by its per-layer dtype
audit. The biases a batch norm follows have no gradient (JAX's float32
ones are under 1e-8): there both bfloat16 gradients are rounding noise,
and the port's is held to at most twice JAX's norm.

StyleGAN2's noise strengths (one scalar a layer, zero at initialisation):
each gradient is ``sum(g * noise)`` over the layer's output, ``g`` the
gradient reaching the injection, a sum that cancels to about a thousandth
of ``sum|g * noise|`` at this size. Its bfloat16 value is uncertain by
what rounding ``g`` to bfloat16 alone can move it, ``2^-8 * sum|g *
noise|`` (``g`` read off the port's step by hooks): the port's is held
within that of JAX's float32 and bfloat16 values, with JAX's sign wherever
JAX's value is larger than that, and within it of ``sum(g * noise)``
taken in float64 from its own ``g`` (its reduction). The cause of the
spread was measured, not assumed: the port's reduction from its own ``g``
agrees with its float64 recomputation (the second 8x8 layer: 9.2e-4
against 1.18e-3), while its bfloat16 ``g`` is 13 % (in norm) from its
float32 one, as bfloat16's rounding leaves it; JAX's own bfloat16 values
lie as far from its float32 ones (1.15e-2, 7.2e-3 and 2.6e-5 on the three
layers, the port's 7.5e-3, 4.9e-3 and 7.3e-3; bound about 2.0e-2). The
float32 and float64 parity tests hold the strengths to JAX's exactly, and
``tests/test_torch_port_bf16_models.py`` holds ``NoiseInjection`` in
bfloat16 where its sum does not cancel."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import contrad_tpu.training.modes as jax_modes
import contrad_tpu_torch.training.modes as port_modes
from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu.models.sndcgan import DSndcgan as JaxD
from contrad_tpu.models.sndcgan import GSndcgan as JaxG
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import GANTrainer as JaxTrainer
from contrad_tpu.training.step import StyleGAN2Trainer as JaxSG2Trainer
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models import get_architecture
from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan
from contrad_tpu_torch.training import GANTrainer, StyleGAN2Trainer
from contrad_tpu_torch.training.step import StepDraws
from contrad_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_port_bf16_models import assert_close
from test_torch_port_checkpoint import assert_bitwise
from test_torch_port_gan_step import (
    RecordingSGD, jax_d_draws, jax_step_draws)
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    jax_mixing, jax_simclr_params, noise_list, one_torch_thread, t, to_np)

BF = jnp.bfloat16
LR = 1e-2  # the D update before the flagship's G phase
READ_LR = 1e6  # an update nothing later in the step reads
REL, COS = 3e-2, 0.99
IMG, NGF, NDF, NZ, D_HIDDEN, N = (16, 16, 3), 16, 16, 32, 64, 4
LEVERS = ["--dtype", "bf16", "--opt_moments", "bf16", "--opt_nu", "bf16",
          "--opt_grads", "bf16"]


class _RecordingAugment:
    """The port's augmentation, logging the dtype of each batch it gets."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def sample(self, shape, rng):
        return self.inner.sample(shape, rng)

    def apply(self, x, params):
        self.log.append(x.dtype)
        return self.inner.apply(x, params)


def _record_losses(monkeypatch, module, log):
    """Log the dtypes of the projections reaching ``nt_xent`` and
    ``supcon_fake`` in ``module`` (the JAX or the port's ``modes``)."""
    for name in ("nt_xent", "supcon_fake"):
        inner = getattr(module, name)

        def wrapped(out1, *args, _inner=inner, **kwargs):
            log.append(out1.dtype)
            return _inner(out1, *args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)


def _dtype_names(log):
    return {str(d).replace("torch.", "") for d in log}


def _assert_losses(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        assert np.isfinite(g), k
        assert abs(g - w) <= REL * abs(w) + 1e-6, f"{k}: port {g}, jax {w}"


def _jax_grads(old, new, lr):
    return torch_state_dict(jax.tree.map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b)) / lr,
        to_np(old), to_np(new)))


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _assert_grads(module, grads, old, new_bf16, new_f32, lr, strengths=None):
    """Per parameter tensor, the cosine of the port's gradient against the
    JAX bfloat16 step's, both read off SGD (``(old - new) / lr``), is at
    least ``COS``, or at least that of JAX's own bfloat16 gradient against
    its float32 one where that is lower (bfloat16's own noise).
    ``strengths``: {noise strength name: (g, noise)}, held by
    ``_assert_strength``."""
    want, f32 = _jax_grads(old, new_bf16, lr), _jax_grads(old, new_f32, lr)
    names = [k for k, _ in module.named_parameters()]
    for name, g in zip(names, grads, strict=True):
        w = want[name]
        if name in (strengths or {}):
            _assert_strength(name, float(g), float(w), float(f32[name]),
                             *strengths[name])
            continue
        if float(f32[name].norm()) < 1e-6:
            # no gradient in float32 (a bias that a batch norm follows):
            # both bfloat16 gradients are rounding noise; the port's is no
            # louder than JAX's
            assert float(g.norm()) <= max(2 * float(w.norm()), 1e-4), name
            continue
        bound = min(COS, _cosine(w, f32[name]))
        cos = _cosine(g, w)
        assert cos >= bound, f"{name}: cosine {cos:.4f} < {bound:.4f}"


def _assert_strength(name, got, jax_bf16, jax_f32, g, noise):
    """A noise strength's gradient ``got`` from the port's upstream
    gradient ``g`` and ``noise`` (float64): within ``2^-8 * sum|g *
    noise|`` of JAX's two values and of ``sum(g * noise)``, and of JAX's
    sign wherever JAX's value exceeds that bound."""
    products = g * noise
    bound = 2.0 ** -8 * float(products.abs().sum())
    for what, want in (("jax bfloat16", jax_bf16), ("jax float32", jax_f32),
                       ("its own sum(g * noise)", float(products.sum()))):
        assert abs(got - want) <= bound, \
            f"{name}: port {got}, {what} {want} (bound {bound})"
        if abs(want) > bound:
            assert np.sign(got) == np.sign(want), (name, what, got, want)


class _StrengthInputs:
    """Hooks on the port's ``NoiseInjection`` modules: per strength, the
    gradient reaching the injection and the noise, from the backward of
    each call that has one."""

    def __init__(self, G):
        from contrad_tpu_torch.models.stylegan2.generator import \
            NoiseInjection

        self.seen = {}
        for name, m in G.named_modules():
            if isinstance(m, NoiseInjection):
                m.register_forward_hook(self._hook(f"{name}.weight"))

    def _hook(self, name):
        def forward_hook(_, args, out):
            if out.requires_grad:
                noise = args[1].detach().double()
                out.register_hook(lambda g: self.seen.setdefault(
                    name, []).append((g.detach().double(), noise)))
        return forward_hook

    def strengths(self):
        out = {}
        for name, calls in self.seen.items():
            assert len(calls) == 1, name  # the G phase's one forward
            g, noise = calls[0]
            out[name] = (g, noise.expand_as(g))
        return out


def test_contrad_gan_step_bf16_matches_jax(monkeypatch):
    G = JaxG(IMG, ngf=NGF, nz=NZ, dtype=BF)
    D = JaxD(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN, dtype=BF)
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    g_vars = jax.jit(lambda k: G.init(k, jnp.zeros((2, NZ)), train=True))(kg)
    d_vars = jax.jit(lambda k: D.init(k, jnp.zeros((2,) + IMG),
                                      train=True))(kd)
    images = np.random.default_rng(7).uniform(size=(N,) + IMG).astype(
        np.float32)
    logs = {"jax_aug": [], "jax_loss": [], "port_aug": [], "port_loss": []}
    _record_losses(monkeypatch, jax_modes, logs["jax_loss"])
    _record_losses(monkeypatch, port_modes, logs["port_loss"])
    jax_aug = jax_get_augment("simclr")

    def recording_jax_aug(rng, x):
        logs["jax_aug"].append(x.dtype)
        return jax_aug(rng, x)

    g_tx, d_tx = optax.sgd(READ_LR), optax.sgd(LR)
    key = jax.random.PRNGKey(9)
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=key, g_params=g_vars["params"],
        g_state={"batch_stats": g_vars["batch_stats"]},
        d_params=d_vars["params"], d_state={"spectral": d_vars["spectral"]},
        g_opt_state=g_tx.init(g_vars["params"]),
        d_opt_state=d_tx.init(d_vars["params"]))

    def jax_step(dtype, augment_fn):
        jt = JaxTrainer(
            JaxG(IMG, ngf=NGF, nz=NZ, dtype=dtype),
            JaxD(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN,
                 dtype=dtype),
            mode="contrad", augment_fn=augment_fn, g_optimizer=g_tx,
            d_optimizer=d_tx, loss_type="nonsat")
        return jax.jit(jt._step)(state, jnp.asarray(images), 0.9)

    new, metrics = jax_step(BF, recording_jax_aug)
    new32, _ = jax_step(jnp.float32, jax_aug)
    draws = jax_step_draws("contrad", "none", key, N, 1, False, IMG, NZ)

    pg = GSndcgan(IMG, ngf=NGF, nz=NZ, dtype=torch.bfloat16)
    pd = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN, dtype=torch.bfloat16)
    pg.load_state_dict(torch_state_dict(
        to_np(g_vars["params"]), {"batch_stats": to_np(g_vars["batch_stats"])}))
    pd.load_state_dict(torch_state_dict(
        to_np(d_vars["params"]), {"spectral": to_np(d_vars["spectral"])}))
    rec_g, rec_d = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = GANTrainer(pg, pd, mode="contrad",
                         augment=_RecordingAugment(get_augment("simclr"),
                                                   logs["port_aug"]),
                         g_optimizer=rec_g, d_optimizer=rec_d,
                         loss_type="nonsat")
    assert trainer.dtype == torch.bfloat16
    got = trainer.train_step(t(images), draws=draws)

    _assert_losses(got, to_np(metrics))
    _assert_grads(pd, rec_d.grads[0], d_vars["params"], new.d_params,
                  new32.d_params, LR)
    _assert_grads(pg, rec_g.grads[0], g_vars["params"], new.g_params,
                  new32.g_params, READ_LR)
    # the control: G in float32 (its gradients about as far from JAX's
    # bfloat16 ones as JAX's float32 ones are) is refused
    ctrl_g = GSndcgan(IMG, ngf=NGF, nz=NZ)
    ctrl_d = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN, dtype=torch.bfloat16)
    ctrl_g.load_state_dict(torch_state_dict(
        to_np(g_vars["params"]), {"batch_stats": to_np(g_vars["batch_stats"])}))
    ctrl_d.load_state_dict(torch_state_dict(
        to_np(d_vars["params"]), {"spectral": to_np(d_vars["spectral"])}))
    ctrl_tx = RecordingSGD(ctrl_g.parameters())
    GANTrainer(ctrl_g, ctrl_d, mode="contrad", augment=get_augment("simclr"),
               g_optimizer=ctrl_tx,
               d_optimizer=RecordingSGD(ctrl_d.parameters()),
               loss_type="nonsat").train_step(t(images), draws=draws)
    with pytest.raises(AssertionError, match="cosine"):
        _assert_grads(ctrl_g, ctrl_tx.grads[0], g_vars["params"],
                      new.g_params, new32.g_params, READ_LR)
    # the dtype audit: the same dtype as JAX's at each cast point
    assert _dtype_names(logs["port_aug"]) == _dtype_names(logs["jax_aug"]) \
        == {"bfloat16"}
    assert _dtype_names(logs["port_loss"]) == _dtype_names(logs["jax_loss"]) \
        == {"float32"}
    have = pd.state_dict()
    want32 = torch_state_dict({}, to_np(new32.d_state))
    for name, w in torch_state_dict({}, to_np(new.d_state)).items():
        assert have[name].dtype == torch.float32 == w.dtype, name
        err = float((have[name] - w).abs().max())
        noise = float((want32[name] - w).abs().max())
        assert err <= max(REL * float(w.abs().max()), 2 * noise), name
    for module, params in ((pg, new.g_params), (pd, new.d_params)):
        for p in module.parameters():
            assert p.dtype == torch.float32
        assert {str(a.dtype) for a in jax.tree.leaves(params)} == {"float32"}


def test_stylegan2_step_with_r1_bf16_matches_jax(monkeypatch):
    size, img = 8, (8, 8, 3)
    G, D = jax_get_architecture("stylegan2_tiny", img, dtype=BF)
    kg, kd = jax.random.split(jax.random.PRNGKey(3))
    g_params = jax.jit(lambda k, z: G.init({"params": k, "noise": k}, z,
                                           train=True)["params"])(
        kg, jnp.zeros((2, G.style_dim)))
    d_params = jax.jit(lambda k, x: D.init(k, x, train=True)["params"])(
        kd, jnp.zeros((2,) + img))
    pg, pd = get_architecture("stylegan2_tiny", img, device="cpu",
                              dtype="bf16")
    pg.load_state_dict(torch_state_dict(to_np(g_params)))
    pd.load_state_dict(torch_state_dict(to_np(d_params)))
    noise = noise_list(pg, N, seed=21)
    images = np.random.default_rng(22).uniform(size=(N,) + img).astype(
        np.float32)
    logs = {"jax_aug": [], "port_aug": [], "jax_loss": [], "port_loss": []}
    _record_losses(monkeypatch, jax_modes, logs["jax_loss"])
    _record_losses(monkeypatch, port_modes, logs["port_loss"])
    jax_aug = jax_get_augment("simclr")

    def recording_jax_aug(rng, x):
        logs["jax_aug"].append(x.dtype)
        return jax_aug(rng, x)

    tx = optax.sgd(READ_LR)  # neither update is read later in the step
    key = jax.random.PRNGKey(23)
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=key, g_params=g_params,
        g_state={}, d_params=d_params, d_state={},
        g_opt_state=tx.init(g_params), d_opt_state=tx.init(d_params),
        g_ema_params=g_params, g_ema_state={})

    def jax_step(dtype, augment_fn):
        jt = JaxSG2Trainer(
            *jax_get_architecture("stylegan2_tiny", img, dtype=dtype),
            mode="contrad", augment_fn=augment_fn, g_optimizer=tx,
            d_optimizer=tx, loss_type="nonsat", lbd_r1=0.1, d_reg_every=1,
            n_critic=1, g_kwargs={"style_mix": 0.9,
                                  "noise": [jnp.asarray(a) for a in noise]})
        return jax.jit(jt._sg2_step, static_argnums=(3,))(
            state, jnp.asarray(images), 0.9, True)

    new, metrics = jax_step(BF, recording_jax_aug)
    new32, _ = jax_step(jnp.float32, jax_aug)

    # the draws of _sg2_step (step.py:482-500), in the port's form
    rng, z_rng, noise_rng, g_loss_rng = jax.random.split(key, 4)
    g_draws = ({"z": t(G.sample_latent(z_rng, N)),
                "noise": [t(a) for a in noise],
                "mixing": jax_mixing(G, {"params": g_params}, noise_rng, N)},
               jax_simclr_params(g_loss_rng, N, size, size))
    _, d_loss_rng, r1_rng = jax.random.split(rng, 3)
    critic = [(None, jax_d_draws("contrad", "none", d_loss_rng, N, img))]
    r1 = jax_simclr_params(r1_rng, N, size, size)

    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    strength_inputs = _StrengthInputs(pg)
    trainer = StyleGAN2Trainer(pg, pd, mode="contrad",
                               augment=_RecordingAugment(get_augment("simclr"),
                                                         logs["port_aug"]),
                               g_optimizer=g_tx, d_optimizer=d_tx,
                               loss_type="nonsat", lbd_r1=0.1, d_reg_every=1)
    assert trainer.dtype == torch.bfloat16
    assert trainer.g_ema.dtype == torch.bfloat16  # EMA G: G's compute dtype
    got = trainer.train_step(t(images), ema_decay=0.9,
                             draws=StepDraws(None, critic, g_draws, r1=r1))
    assert float(got["D_r1"]) > 0
    _assert_losses(got, to_np(metrics))
    _assert_grads(pd, d_tx.grads[0], d_params, new.d_params, new32.d_params,
                  READ_LR)
    strengths = strength_inputs.strengths()
    assert len(strengths) == 3  # every layer's
    _assert_grads(pg, g_tx.grads[0], g_params, new.g_params, new32.g_params,
                  READ_LR, strengths)
    assert _dtype_names(logs["port_aug"]) == _dtype_names(logs["jax_aug"]) \
        == {"bfloat16"}
    assert _dtype_names(logs["port_loss"]) == _dtype_names(logs["jax_loss"]) \
        == {"float32"}
    for p in list(pg.parameters()) + list(pd.parameters()):
        assert p.dtype == torch.float32


# ------------------------------------------------------------------ the CLIs

GAN = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
       "--aug", "simclr", "--use_warmup", "--device", "cpu", "--print_every",
       "1", "--evaluate_every", "1", "--no_fid", "--no_gif", "--override",
       "options.dataset=synthetic_16_256", "options.batch_size=4"]
SG2 = ["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny", "--mode",
       "contrad", "--aug", "simclr", "--lbd_r1", "0.1", "--d_reg_every", "2",
       "--halflife_k", "1", "--ema_start_k", "0", "--use_warmup", "--device",
       "cpu", "--print_every", "1", "--evaluate_every", "1", "--fid_embed",
       "moments", "--n_eval_avg", "1", "--override",
       "options.dataset=synthetic_8_256", "options.batch_size=4",
       "options.fid_size=16"]
SG512 = ["configs/gan/stylegan2/afhq_dog_style64.toml", "stylegan2_tiny",
         "--halflife_k", "20", "--use_warmup", "--d_reg_every", "2",
         "--device", "cpu", "--print_every", "1", "--evaluate_every", "1",
         "--no_fid", "--no_gif", "--override",
         "options.dataset=synthetic_16_256", "options.batch_size=4"]


@pytest.fixture(scope="module")
def stats_dir(tmp_path_factory):
    import contrad_tpu_torch.evaluate.fid as pfid

    with pytest.MonkeyPatch.context() as mp:
        d = str(tmp_path_factory.mktemp("fid_stats"))
        mp.setattr(pfid, "STATS_DIR", d)
        yield d


@pytest.mark.parametrize("cli,argv", [
    ("train_gan", GAN), ("train_stylegan2", SG2),
    ("train_stylegan2_contraD", SG512)])
def test_cli_runs_the_production_stack_and_resumes_bitwise(
        tmp_path, stats_dir, cli, argv):
    import importlib
    import os

    main = importlib.import_module(f"contrad_tpu_torch.{cli}").main
    root = ["--logdir_root", str(tmp_path)]
    argv = argv + ["options.max_steps=2"] + LEVERS + root
    straight = main(argv)
    assert [r["step"] for r in straight] == [1, 2]
    for r in straight:
        assert all(np.isfinite(v) for k, v in r.items() if k != "step"), r
    first = main(argv[:argv.index("options.max_steps=2")]
                 + ["options.max_steps=1"]
                 + argv[argv.index("options.max_steps=2") + 1:])
    resumed = main(argv + ["--resume", first.logdir])
    assert [r["step"] for r in resumed] == [2]
    assert straight[1] == dict(resumed[0], seconds_per_step=straight[1][
        "seconds_per_step"])
    want = restore_checkpoint(straight.logdir)
    got = restore_checkpoint(first.logdir)
    assert_bitwise(want, got)
    for opt in ("g_optimizer", "d_optimizer"):
        for entry in got[opt]["adam"]["state"].values():
            assert entry["exp_avg"].dtype == torch.bfloat16
            assert entry["exp_avg_sq"].dtype == torch.bfloat16
    for tree in ("generator", "discriminator"):
        assert all(v.dtype == torch.float32 for v in got[tree].values())
    log = open(os.path.join(straight.logdir, "log.txt")).read()
    assert "precision: dtype bf16, opt_moments bf16, opt_nu bf16, " \
           "opt_grads bf16" in log
    if cli == "train_stylegan2":
        # FID of the bfloat16 EMA G in eval mode, and its GIF frames
        assert [e["step"] for e in straight.evals] == [1, 2]
        assert all(np.isfinite(e["fid"]) for e in straight.evals)
        gifs = [f for f in os.listdir(straight.logdir) if f.endswith(".gif")]
        assert len(gifs) == 1


def test_eval_clis_load_a_bf16_run(tmp_path):
    """The evaluation CLIs take no ``--dtype`` (nor do JAX's): they build
    the float32 models and load a bfloat16 run's float32 parameters as they
    are."""
    import os

    from contrad_tpu_torch import test_gan_sample, train_gan
    from contrad_tpu_torch.utils.run_loading import load_run

    run = train_gan.main(GAN + ["options.max_steps=1", "--logdir_root",
                                str(tmp_path)] + LEVERS)
    _, G, D, _, _ = load_run(run.logdir, "sndcgan", device="cpu")
    assert G.dtype is None and D.dtype is None  # float32 models
    saved = restore_checkpoint(run.logdir)
    for module, tree in ((G, "generator"), (D, "discriminator")):
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[tree][k]), k
    out = test_gan_sample.main([run.logdir, "sndcgan", "--n_samples", "4",
                                "--batch_size", "4", "--device", "cpu"])
    assert len(os.listdir(out)) == 4
