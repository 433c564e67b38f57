"""The port's data-parallel train step against the JAX package's on its
8-device virtual mesh: a 2-process gloo world of the port
(``contrad_tpu_torch/parallel/_mh_worker.py --cases``, two processes through
``hostenv.spawn_world``) and JAX's step over ``get_mesh()`` (the suite's 8
CPU devices) take the same numpy inputs, the same weights
(``contrad_tpu_torch/bridge.py``) and the same draws (reproduced from the
JAX step's key, as ``tests/test_torch_port_gan_step.py`` and
``tests/test_torch_port_blocks.py`` reproduce them); each rank takes its rows
of the global batch and of every per-sample draw, and the workers write
their results to files that the tests read.

Cases, batch 8 (4 rows a rank): SNDCGAN ``contrad`` at ``n_critic`` 1, and
at 2 with the reals' flip and the EMA; the conditional D; ``std`` with the
``gp`` penalty (16x16, ngf = ndf = 16, float64 in both packages, one step of
SGD at rate ``LR``); ``stylegan2_tiny`` at 16 channels a layer, 16x16, three
steps with the EMA gate and a lazy-R1 step (in float32: JAX's block does not
build under ``enable_x64``, ``tests/test_torch_port_blocks.py``).

Checked per case:
  * against JAX, with the existing parity tests' rules: losses and
    gradients rtol 1e-3 / atol 1e-5, parameters after the updates rtol 1e-5
    / atol 1e-6, ``u`` and batch-norm statistics rtol 1e-4 / atol 1e-6
    (float64); StyleGAN2's summed gradients as ``tests/test_torch_port_
    blocks.py`` holds a float32 block's (max|port - JAX| <= 1e-5 + 5e-3
    max|JAX|, at most 1 % of the elements off by over 1 %);
  * every replicated tensor bitwise equal across the two ranks (parameters,
    ``u``, batch-norm statistics, EMA, the gradients after the all-reduce,
    the metrics);
  * the world of 2 against the port in one process (no world) on the same
    inputs, in float64 (the StyleGAN2 case made double for this): each
    tensor within 1e-6 of its largest magnitude, with an absolute floor of
    1e-12 for tensors that are float64 rounding noise (a bias in front of a
    batch norm, whose gradient is 0 but for rounding, moves by SGD steps of
    that size).
"""

import copy
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.parallel.mesh import get_mesh
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import GANTrainer as JaxTrainer
from contrad_tpu.training.step import StyleGAN2Trainer as JaxSG2Trainer
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.hostenv import (
    free_port, rank_env, spawn_world, worker_env)
from contrad_tpu_torch.parallel._mh_worker import run_case
from contrad_tpu_torch.training.modes import Draws
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_blocks import _data, _sndcgan_pair, summing_sgd
from test_torch_port_gan_step import (
    LR, UPDATE_TOL, _compare_grads, _compare_metrics, _compare_module,
    _compare_state, jax_step_draws)
from test_torch_port_sndcgan import IMG
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_fake_labels, jax_mixing, jax_simclr_params, noise_list,
    one_torch_thread, t, to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8  # the global batch
WORLD = 2
SNDCGAN = {  # case: (mode, penalty, n_critic, reals' flip and EMA, classes)
    "contrad": ("contrad", "none", 1, False, 1),
    "contrad_nc2": ("contrad", "none", 2, True, 1),
    "conditional": ("contrad", "none", 1, False, 10),
    "std_gp": ("std", "gp", 1, False, 1),
}
CASES = list(SNDCGAN) + ["stylegan2_tiny"]


def sndcgan_case(name):
    """JAX's step on the 8-device mesh and the port's case (global inputs,
    weights, draws)."""
    mode, penalty, n_critic, flip, n_classes = SNDCGAN[name]
    G, D, g_vars, d_vars, pg, pd = _sndcgan_pair(n_classes)
    rng = np.random.default_rng(7)
    images = rng.uniform(size=(n_critic * N,) + IMG)
    labels = (rng.integers(0, n_classes, size=n_critic * N)
              if n_classes > 1 else None)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        tx = optax.sgd(LR)
        jt = JaxTrainer(G, D, mode=mode, augment_fn=jax_get_augment("simclr"),
                        g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                        penalty=penalty, n_critic=n_critic, ema=flip,
                        real_aug_fn=(jax_get_augment("hflip") if flip
                                     else None), mesh=get_mesh())
        g_state = {"batch_stats": g_vars["batch_stats"]}
        state = jt.place_state(GANTrainState(  # donated: a copy of the key
            step=jnp.zeros((), jnp.int32), rng=jnp.array(key),
            g_params=g_vars["params"], g_state=g_state,
            d_params=d_vars["params"], d_state={"spectral": d_vars["spectral"]},
            g_opt_state=tx.init(g_vars["params"]),
            d_opt_state=tx.init(d_vars["params"]),
            g_ema_params=g_vars["params"] if flip else None,
            g_ema_state=g_state if flip else None))
        new, metrics = jt.train_step(
            state, jt.place_batch(images), 0.9,
            labels=None if labels is None else jt.place_batch(labels))
        draws = jax_step_draws(mode, penalty, key, N, n_critic, flip)
        if n_classes > 1:
            draws = draws._replace(y_gen=jax_fake_labels(key, N, n_critic,
                                                         n_classes, flip))
    want = dict(jax_old=(g_vars, d_vars), jax=to_np(new),
                jax_metrics=to_np(metrics))
    case = dict(kind="gan", G=pg, D=pd, lr=LR, batch=N, trainer=dict(
        mode=mode, aug="simclr", loss_type="nonsat", penalty=penalty,
        n_critic=n_critic, ema=flip, real_aug="hflip" if flip else None),
        steps=[dict(images=torch.from_numpy(images), draws=draws,
                    labels=(None if labels is None
                            else torch.from_numpy(labels)), ema_decay=0.9)])
    return want, case


def stylegan2_case(monkeypatch):
    """Three steps of JAX's StyleGAN2 block (R1 at the second, the EMA gate
    open after the first) on the 8-device mesh, and the port's case."""
    import contrad_tpu.models.stylegan2.discriminator as jax_dmod
    import contrad_tpu.models.stylegan2.generator as jax_gmod
    import contrad_tpu_torch.models.stylegan2.discriminator as dmod
    import contrad_tpu_torch.models.stylegan2.generator as gmod

    for module in (jax_gmod, jax_dmod, gmod, dmod):
        monkeypatch.setattr(module, "stylegan2_channels",
                            lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})
    k, size = 3, 16
    G, D, g_params, d_params, pg, pd = build_pair("stylegan2_tiny", size, 2)
    g_params, d_params = to_np(g_params), to_np(d_params)
    noise = noise_list(pg, N, seed=23)
    dataset = _data(size, 1)
    idx = np.random.default_rng(4).permutation(len(dataset.images))[
        :k * N].reshape(k, N).astype(np.int32)
    ema = np.array([0.0, 0.9, 0.9], np.float32)
    r1 = np.array([False, True, False])
    key = jax.random.PRNGKey(17)
    tx = summing_sgd()
    jt = JaxSG2Trainer(G, D, mode="std", augment_fn=jax_get_augment("simclr"),
                       g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                       lbd_r1=0.1, d_reg_every=4, mesh=get_mesh(),
                       g_kwargs={"style_mix": 0.9,
                                 "noise": [jnp.asarray(a) for a in noise]})
    cp = lambda tree: jax.tree.map(jnp.array, tree)  # the block donates
    state = jt.place_state(GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=cp(key),
        g_params=cp(g_params), g_state={}, d_params=cp(d_params),
        d_state={}, g_opt_state=tx.init(g_params),
        d_opt_state=tx.init(d_params), g_ema_params=cp(g_params),
        g_ema_state={}))
    new, metrics = jt.train_steps_indexed(
        state, jnp.asarray(dataset.images), jnp.asarray(idx),
        ema_decay=ema, do_r1=r1)
    variables, noise_t, steps, rng = {"params": g_params}, [
        t(a) for a in noise], [], key
    for j in range(k):  # step.py:482-534, in the port's form
        rng, z_rng, noise_rng, _ = jax.random.split(rng, 4)
        g = ({"z": t(G.sample_latent(z_rng, N)), "noise": noise_t,
              "mixing": jax_mixing(G, variables, noise_rng, N)}, None)
        rng, _, r1_rng = jax.random.split(rng, 3)
        draws = StepDraws(None, [(None, Draws())], g, r1=(
            jax_simclr_params(r1_rng, N, size, size) if r1[j] else None))
        rng = jax.random.split(rng)[1]
        steps.append(dict(images=torch.from_numpy(dataset.images[idx[j]]),
                          draws=draws, ema_decay=float(ema[j]),
                          do_r1=bool(r1[j])))
    want = dict(jax=to_np(new), jax_metrics=to_np(metrics))
    case = dict(kind="sg2", G=pg, D=pd, lr=LR, batch=N, steps=steps,
                trainer=dict(mode="std", aug="simclr", loss_type="nonsat",
                             lbd_r1=0.1, d_reg_every=4))
    return want, case


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        out = {name: sndcgan_case(name) for name in SNDCGAN}
        out["stylegan2_tiny"] = stylegan2_case(mp)
        sg2 = out["stylegan2_tiny"][1]
        out["stylegan2_tiny_f64"] = (None, dict(
            sg2, G=copy.deepcopy(sg2["G"]).double(),
            D=copy.deepcopy(sg2["D"]).double()))
        path = str(tmp_path_factory.mktemp("world") / "cases.pt")
        torch.save({k: v[1] for k, v in out.items()}, path)
    return out, path


@pytest.fixture(scope="module")
def ranks(prepared, tmp_path_factory):
    _, path = prepared
    res = str(tmp_path_factory.mktemp("world") / "result")
    port = free_port()
    env = dict(worker_env(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "contrad_tpu_torch.parallel._mh_worker",
           "--device", "cpu", "--cases", path, "--out", res, "--world",
           str(WORLD), "--port", str(port)]
    spawn_world([(cmd + ["--rank", str(r)], env) for r in range(WORLD)],
                cwd=ROOT, timeout=900)
    return [torch.load(f"{res}.rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def solo(prepared):
    cases = torch.load(prepared[1], weights_only=False)
    return {name: run_case(case, torch.device("cpu"))
            for name, case in cases.items()}


def _modules(case, state):
    """The case's G, D (and EMA G) holding a rank's final state."""
    def load(module, prefix):
        m = copy.deepcopy(module)
        m.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                           if k.startswith(prefix)}, strict=True)
        return m

    g = load(case["G"], "generator/")
    ema = (load(case["G"], "g_ema/")
           if any(k.startswith("g_ema/") for k in state) else None)
    return SimpleNamespace(generator=g, g_ema=ema,
                           discriminator=load(case["D"], "discriminator/"))


@pytest.mark.parametrize("name", list(SNDCGAN))
def test_sndcgan_world_matches_jax_on_its_mesh(prepared, ranks, name):
    want, case = prepared[0][name]
    for rank in ranks:
        got = rank[name]
        r = dict(want, trainer=_modules(case, got["state"]),
                 metrics=got["metrics"][0],
                 d_tx=SimpleNamespace(grads=got["d_grads"]),
                 g_tx=SimpleNamespace(grads=got["g_grads"]))
        assert len(got["d_grads"]) == SNDCGAN[name][2]
        _compare_metrics(r)
        _compare_grads(r)
        _compare_state(r)
        if SNDCGAN[name][3]:
            new = want["jax"]
            _compare_module(r["trainer"].g_ema, new.g_ema_params,
                            new.g_ema_state, UPDATE_TOL, "G EMA")


def test_stylegan2_world_with_r1_and_ema_matches_jax_on_its_mesh(prepared,
                                                                 ranks):
    from test_torch_port_sg512_models import assert_close_to_scale

    want, case = prepared[0]["stylegan2_tiny"]
    new = want["jax"]
    for rank in ranks:
        got = rank["stylegan2_tiny"]
        _compare_metrics(dict(metrics=got["metrics"][-1],
                              jax_metrics=want["jax_metrics"]))
        assert got["metrics"][1]["D_r1"] > 0 == got["metrics"][-1]["D_r1"]
        mods = _modules(case, got["state"])
        for grads, sums, module in ((got["d_grads"], new.d_opt_state,
                                     case["D"]),
                                    (got["g_grads"], new.g_opt_state,
                                     case["G"])):
            assert len(grads) == 3
            ref = torch_state_dict(sums)
            names = [n for n, _ in module.named_parameters()]
            for n, g in zip(names, [sum(gs) for gs in zip(*grads)],
                            strict=True):
                assert_close_to_scale(g.numpy(), ref[n].numpy(), n,
                                      frac=5e-3, share=0.01)
        for module, params in ((mods.discriminator, new.d_params),
                               (mods.generator, new.g_params),
                               (mods.g_ema, new.g_ema_params)):
            _compare_module(module, params, {}, UPDATE_TOL, "parameters")


@pytest.mark.parametrize("name", CASES + ["stylegan2_tiny_f64"])
def test_replicas_are_bitwise_equal_across_ranks(ranks, name):
    a, b = ranks[0][name], ranks[1][name]
    assert a["metrics"] == b["metrics"]
    assert a["state"].keys() == b["state"].keys() and len(a["state"]) > 10
    for key, v in a["state"].items():
        assert torch.equal(v, b["state"][key]), key
    for which in ("g_grads", "d_grads"):
        for ga, gb in zip(a[which], b[which], strict=True):
            for x, y in zip(ga, gb, strict=True):
                assert torch.equal(x, y), which


def _close(got, want, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= 1e-6 * scale + 1e-12, f"{what}: {err:.3g} (scale {scale:.3g})"


@pytest.mark.parametrize("name", list(SNDCGAN) + ["stylegan2_tiny_f64"])
def test_world_of_two_matches_one_process(ranks, solo, name):
    got, want = ranks[0][name], solo[name]
    for m_got, m_want in zip(got["metrics"], want["metrics"], strict=True):
        for k in m_want:
            _close(m_got[k], m_want[k], f"metric {k}")
    assert got["state"].keys() == want["state"].keys()
    for key, v in want["state"].items():
        if v.is_floating_point():
            _close(got["state"][key], v, key)
        else:
            assert torch.equal(got["state"][key], v), key
    for which in ("g_grads", "d_grads"):
        for ga, gw in zip(got[which], want[which], strict=True):
            for x, y in zip(ga, gw, strict=True):
                _close(x, y, which)
