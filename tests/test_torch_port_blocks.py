"""Blocks of train steps through the port's multi-step dispatch
(``contrad_tpu_torch/training/dispatch.py`` and ``training/graph.py``), on
the CPU, where a block runs its steps eagerly (the plain version of the
card's CUDA graph replays):

  * K steps through the dispatcher equal K sequential ``train_step`` calls
    bit for bit (every parameter, Adam moment and count, ``u``, batch-norm
    statistic, EMA tensor, the random stream and the last metrics): the
    flagship (SNDCGAN + ContraD, Adam with warmup), its conditional form and
    ``stylegan2_tiny`` with lazy R1 (``d_reg_every = 4``) and the EMA gate
    opening inside a block, each through its CLI's ``build`` at 16x16,
    batch 4, two blocks of 4;
  * a block of 3 steps equals JAX's ``train_steps_indexed`` (one
    ``lax.scan`` program) on the same index block, weights (``bridge.py``)
    and draws (each step's, reproduced from the key JAX's step carries to
    the next), with plain SGD at rate ``LR`` so that the block's summed
    gradients can be read off the updates, as in
    ``tests/test_torch_port_gan_step.py``: the flagship (as
    ``tests/test_step.py:335``) and its conditional form in float64, with
    that file's tolerances (losses and gradients rtol 1e-3 / atol 1e-5,
    parameters rtol 1e-5 / atol 1e-6, ``u`` and batch-norm statistics rtol
    1e-4 / atol 1e-6); ``stylegan2_tiny`` with R1 inside the block and the
    EMA gate (as ``tests/test_stylegan2.py:296``) in float32, its summed
    gradients held as ``tests/test_torch_port_sg512_step.py`` holds a
    float32 step's (the test's docstring says why);
  * a capture-safety audit: one step of each trainer as the graph runner
    captures it (``BlockRunner._graph_step`` on its static row), after one
    warm-up step, with ``torch.Tensor.__bool__``, ``__float__``,
    ``__int__``, ``__index__``, ``item``, ``tolist``, ``numpy`` and ``cpu``
    and ``torch.tensor``, ``as_tensor`` and ``from_numpy`` made to raise
    (on the card, reading a device value on the host or copying from it
    cannot be captured) and the capture flag set: the step touches none of
    them, and no Python-side state (counts, flags, the blur's launch
    counts) changes. Controls: an eager step does change the Python-side
    state, and the jitter's old host-drawn order (a CPU generator and a
    Python ``if``) fails the audit.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models.sndcgan import DSndcgan as JaxD
from contrad_tpu.models.sndcgan import GSndcgan as JaxG
from contrad_tpu.parallel.mesh import get_mesh
from contrad_tpu.training.state import GANTrainState
from contrad_tpu.training.step import GANTrainer as JaxTrainer
from contrad_tpu.training.step import StyleGAN2Trainer as JaxSG2Trainer
from contrad_tpu_torch import train_gan, train_stylegan2
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.augment.color import ColorJitter
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.data import DeviceBatchIterator
from contrad_tpu_torch.data.core import ArrayDataset
from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan
from contrad_tpu_torch.ops import blur
from contrad_tpu_torch.training import GANTrainer, StyleGAN2Trainer
from contrad_tpu_torch.training import state as state_module
from contrad_tpu_torch.training.dispatch import BlockDispatcher
from contrad_tpu_torch.training.graph import BlockRunner
from contrad_tpu_torch.training.modes import Draws
from contrad_tpu_torch.training.step import StepDraws
from test_torch_port_gan_step import (
    LR, UPDATE_TOL, RecordingSGD, _compare_grads, _compare_metrics,
    _compare_module, _compare_state, jax_step_draws)
from test_torch_port_sndcgan import D_HIDDEN, IMG, NDF, NGF, NZ, _f64
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_fake_labels, jax_mixing, jax_simclr_params, noise_list,
    one_torch_thread, t, to_np)

# the three trainers, each through its CLI's build: (CLI, arguments, data)
CASES = {
    "flagship": (train_gan, [
        "configs/gan/cifar10/c10_b512.toml", "sndcgan", "--mode", "contrad",
        "--aug", "simclr", "--use_warmup"], "synthetic_16_64"),
    "conditional": (train_gan, [
        "configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
        "--aug", "simclr", "--use_warmup", "--conditional"],
        "synthetic_16_256"),
    "stylegan2_tiny": (train_stylegan2, [
        "configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny", "--mode",
        "contrad", "--aug", "simclr", "--lbd_r1", "0.1", "--d_reg_every", "4",
        "--use_warmup"], "synthetic_16_64"),
}


def _build(case):
    cli, argv, data = CASES[case]
    P = cli.parse_args(argv + ["--device", "cpu", "--override",
                               f"options.dataset={data}",
                               "options.batch_size=4"])
    _, loader, trainer = cli.build(P)
    return loader, trainer


def _step_args(case, steps):
    """Each step's EMA decay and R1 flag: for StyleGAN2 the gate opens after
    step 2 (inside the first block) and R1 comes every 4 steps."""
    if case != "stylegan2_tiny":
        return np.zeros(len(steps)), np.zeros(len(steps), bool)
    return np.where(steps > 2, 0.99, 0.0), steps % 4 == 0


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree} if isinstance(tree, (int, float)) else {}


def _everything(trainer, metrics):
    out = _flat(trainer.state_dict())
    out.update({f"metric/{k}": v for k, v in metrics.items()})
    out["g_count_t"], out["d_count_t"] = (trainer.g_tx.count_t,
                                          trainer.d_tx.count_t)
    return out


# --------------------------------------------------- block == sequential

@pytest.mark.parametrize("case", list(CASES))
def test_block_equals_sequential_steps_bitwise(case):
    k, n_steps = 4, 8
    loader, trainer = _build(case)
    dispatcher = BlockDispatcher(loader, k, n_steps)
    runner = BlockRunner(trainer, loader)
    step, idx_seen = 1, []
    while step <= n_steps:
        blk = dispatcher.next_block(step)
        assert blk.kind == "block" and blk.k == k
        ema, r1 = _step_args(case, np.arange(step, step + k))
        metrics = runner.run(blk.idx_block, blk.labels_block
                             if trainer.conditional else None, ema, r1)
        idx_seen += list(blk.idx_block)
        step += k

    loader_b, seq = _build(case)
    ema, r1 = _step_args(case, np.arange(1, n_steps + 1))
    for i in range(n_steps):
        idx, labels = loader_b.next_indices()
        np.testing.assert_array_equal(idx, idx_seen[i])
        kwargs = ({"labels": torch.from_numpy(labels)} if seq.conditional
                  else {})
        if case == "stylegan2_tiny":
            kwargs["do_r1"] = bool(r1[i])
        want = seq.train_step(loader_b.materialize(idx),
                              ema_decay=float(ema[i]), **kwargs)
    if case == "stylegan2_tiny":
        assert float(want["D_r1"]) > 0  # step 8 carries R1
    got, ref = _everything(trainer, metrics), _everything(seq, want)
    assert got.keys() == ref.keys()
    for name, a in ref.items():
        b = got[name]
        if isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype and torch.equal(a, b), name
        else:
            assert a == b, name
    assert trainer.g_tx.count == n_steps


# ------------------------------------------------------ against JAX's scan

def _sndcgan_pair(n_classes):
    """JAX's SNDCGAN G and D in float64 (``tests/test_torch_port_sndcgan.py``
    widths) with ``n_classes``, their variables, and the port's twins."""
    with jax.enable_x64(True):
        G = JaxG(IMG, ngf=NGF, nz=NZ, dtype=jnp.float64)
        D = JaxD(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN,
                 dtype=jnp.float64, n_classes=n_classes)
        kg, kd = jax.random.split(jax.random.PRNGKey(5))
        g_vars = jax.jit(lambda k: G.init(k, jnp.zeros((2, NZ)),
                                          train=True))(kg)
        y = {"y": jnp.zeros((2,), jnp.int32)} if n_classes > 1 else {}
        d_vars = jax.jit(lambda k: D.init(k, jnp.zeros((2,) + IMG),
                                          train=True, **y))(kd)
    g_vars = {"params": _f64(g_vars["params"]),
              "batch_stats": _f64(g_vars["batch_stats"])}
    d_vars = {"params": _f64(d_vars["params"]),
              "spectral": to_np(d_vars["spectral"])}
    pg = GSndcgan(IMG, ngf=NGF, nz=NZ).double()
    pd = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN,
                  n_classes=n_classes).double()
    pg.load_state_dict(torch_state_dict(
        g_vars["params"], {"batch_stats": g_vars["batch_stats"]}), strict=True)
    pd.load_state_dict(torch_state_dict(
        d_vars["params"], {"spectral": d_vars["spectral"]}), strict=True)
    return G, D, g_vars, d_vars, pg, pd


def _data(size, n_classes, seed=21):
    rng = np.random.default_rng(seed)
    return ArrayDataset(rng.integers(0, 256, size=(40, size, size, 3),
                                     dtype=np.uint8),
                        rng.integers(0, n_classes, size=40),
                        n_classes=n_classes)


def _dispatched_block(dataset, k, n, conditional):
    """The port's dispatcher's first block of ``k`` steps on ``dataset``."""
    loader = DeviceBatchIterator(dataset, n, seed=3, device="cpu",
                                 with_labels=conditional)
    blk = BlockDispatcher(loader, k, k).next_block(1)
    assert blk.kind == "block" and blk.k == k
    return loader, blk


def _feed(trainer, draws):
    """``trainer.draw_step`` hands out ``draws`` in order (JAX's, one
    ``StepDraws`` a step) and checks R1's flag against them."""
    queue = iter(draws)

    def draw_step(shape, with_r1=False):
        d = next(queue)
        assert with_r1 == (d.r1 is not None)
        return d

    trainer.draw_step = draw_step


def _gan_key_chain(key, k):
    """The key each ``GANTrainer._step`` of a block starts from
    (``step.py:238-281``: n_critic 1, no real augmentation)."""
    keys = [key]
    for _ in range(k):
        rng, *_ = jax.random.split(keys[-1], 5)  # the D sub-step
        keys.append(jax.random.split(rng, 6)[5])  # next_rng
    return keys


@pytest.mark.parametrize("n_classes", [1, 10], ids=["flagship",
                                                    "conditional"])
def test_flagship_block_matches_jax_train_steps_indexed(n_classes):
    k, n = 3, 8
    G, D, g_vars, d_vars, pg, pd = _sndcgan_pair(n_classes)
    conditional = n_classes > 1
    dataset = _data(IMG[0], n_classes)
    loader, blk = _dispatched_block(dataset, k, n, conditional)
    key = jax.random.PRNGKey(9)
    keys = _gan_key_chain(key, k)
    with jax.enable_x64(True):
        tx = optax.sgd(LR)
        jt = JaxTrainer(G, D, mode="contrad",
                        augment_fn=jax_get_augment("simclr"), g_optimizer=tx,
                        d_optimizer=tx, loss_type="nonsat",
                        mesh=get_mesh(jax.devices()[:1]))
        state = GANTrainState(  # donated to the block: a copy of the key
            step=jnp.zeros((), jnp.int32), rng=jnp.asarray(np.asarray(key)),
            g_params=g_vars["params"],
            g_state={"batch_stats": g_vars["batch_stats"]},
            d_params=d_vars["params"], d_state={"spectral": d_vars["spectral"]},
            g_opt_state=tx.init(g_vars["params"]),
            d_opt_state=tx.init(d_vars["params"]))
        new, metrics = jt.train_steps_indexed(
            state, jnp.asarray(dataset.images), jnp.asarray(blk.idx_block),
            labels_block=(np.stack(blk.labels_block) if conditional
                          else None))
        draws = []
        for kk in keys[:k]:
            d = jax_step_draws("contrad", "none", kk, n, 1, False)
            draws.append(d._replace(y_gen=jax_fake_labels(kk, n, 1, n_classes))
                         if conditional else d)
    new, metrics = to_np(new), to_np(metrics)
    np.testing.assert_array_equal(np.asarray(new.rng), np.asarray(keys[k]))

    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = GANTrainer(pg, pd, mode="contrad", augment=get_augment("simclr"),
                         g_optimizer=g_tx, d_optimizer=d_tx,
                         loss_type="nonsat")
    _feed(trainer, draws)
    got = BlockRunner(trainer, loader).run(
        blk.idx_block, blk.labels_block if conditional else None)
    assert len(d_tx.grads) == len(g_tx.grads) == k
    r = dict(jax_old=(g_vars, d_vars), jax=new, jax_metrics=metrics,
             trainer=trainer, metrics=got, g_tx=g_tx, d_tx=d_tx)
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)


def summing_sgd() -> optax.GradientTransformation:
    """SGD at rate ``LR`` whose state is the sum of the gradients it was
    given (float32 SGD updates lose a gradient far smaller than its
    parameter, ``tests/test_torch_port_sg512_step.py``)."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(lambda g: -LR * g, grads),
            jax.tree.map(jnp.add, state, grads)))


def test_stylegan2_block_with_r1_and_ema_matches_jax_train_steps_indexed(
        monkeypatch):
    """In float32, at 16 channels a layer (as ``tests/test_stylegan2.py``'s
    block test): under ``enable_x64`` JAX's own block does not build (its
    ``lax.cond`` between the R1 and plain D losses gets a float32 R1 and a
    float64 zero), and at ``stylegan2_tiny``'s widths it compiles for three
    minutes. The kinks move single gradient elements in float32, so each
    summed gradient is held as ``tests/test_torch_port_sg512_step.py``
    holds a float32 step's: max|port - JAX| <= 1e-5 + 5e-3 max|JAX|, at
    most 1 % of its elements off by over 1 %."""
    import contrad_tpu.models.stylegan2.discriminator as jax_dmod
    import contrad_tpu.models.stylegan2.generator as jax_gmod
    import contrad_tpu_torch.models.stylegan2.discriminator as dmod
    import contrad_tpu_torch.models.stylegan2.generator as gmod
    from test_torch_port_sg512_models import assert_close_to_scale

    for module in (jax_gmod, jax_dmod, gmod, dmod):
        monkeypatch.setattr(module, "stylegan2_channels",
                            lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})
    k, n, size = 3, 8, 16
    G, D, g_params, d_params, pg, pd = build_pair("stylegan2_tiny", size, 2)
    g_params, d_params = to_np(g_params), to_np(d_params)
    noise = noise_list(pg, n, seed=23)
    dataset = _data(size, 1)
    loader, blk = _dispatched_block(dataset, k, n, False)
    ema = np.array([0.0, 0.9, 0.9], np.float32)
    r1 = np.array([False, True, False])
    key = jax.random.PRNGKey(17)
    tx = summing_sgd()
    jt = JaxSG2Trainer(G, D, mode="std", augment_fn=jax_get_augment("simclr"),
                       g_optimizer=tx, d_optimizer=tx, loss_type="nonsat",
                       lbd_r1=0.1, d_reg_every=4,
                       mesh=get_mesh(jax.devices()[:1]),
                       g_kwargs={"style_mix": 0.9,
                                 "noise": [jnp.asarray(a) for a in noise]})
    copy = lambda tree: jax.tree.map(jnp.array, tree)  # the block donates
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=copy(key),
        g_params=copy(g_params), g_state={}, d_params=copy(d_params),
        d_state={}, g_opt_state=tx.init(g_params),
        d_opt_state=tx.init(d_params), g_ema_params=copy(g_params),
        g_ema_state={})
    new, metrics = jt.train_steps_indexed(
        state, jnp.asarray(dataset.images), jnp.asarray(blk.idx_block),
        ema_decay=ema, do_r1=r1)
    # each step's draws (step.py:482-534), in the port's form
    variables, noise_t, draws, rng = {"params": g_params}, [
        t(a) for a in noise], [], key
    for j in range(k):
        rng, z_rng, noise_rng, _ = jax.random.split(rng, 4)
        g = ({"z": t(G.sample_latent(z_rng, n)), "noise": noise_t,
              "mixing": jax_mixing(G, variables, noise_rng, n)}, None)
        rng, _, r1_rng = jax.random.split(rng, 3)
        draws.append(StepDraws(None, [(None, Draws())], g, r1=(
            jax_simclr_params(r1_rng, n, size, size) if r1[j] else None)))
        rng = jax.random.split(rng)[1]
    new, metrics = to_np(new), to_np(metrics)
    np.testing.assert_array_equal(np.asarray(new.rng), np.asarray(rng))

    g_tx, d_tx = RecordingSGD(pg.parameters()), RecordingSGD(pd.parameters())
    trainer = StyleGAN2Trainer(pg, pd, mode="std",
                               augment=get_augment("simclr"),
                               g_optimizer=g_tx, d_optimizer=d_tx,
                               loss_type="nonsat", lbd_r1=0.1, d_reg_every=4)
    _feed(trainer, draws)
    got = BlockRunner(trainer, loader).run(blk.idx_block, None, ema, r1)
    _compare_metrics(dict(metrics=got, jax_metrics=metrics))
    assert float(got["D_r1"]) == 0.0  # the block's last step has none
    for tx_, sums, module in ((d_tx, new.d_opt_state, pd),
                              (g_tx, new.g_opt_state, pg)):
        want = torch_state_dict(sums)
        names = [name for name, _ in module.named_parameters()]
        summed = [sum(gs) for gs in zip(*tx_.grads)]
        assert len(tx_.grads) == k
        for name, g in zip(names, summed, strict=True):
            assert_close_to_scale(g.numpy(), want[name].numpy(), name,
                                  frac=5e-3, share=0.01)
    for module, params in ((pd, new.d_params), (pg, new.g_params),
                           (trainer.g_ema, new.g_ema_params)):
        _compare_module(module, params, {}, UPDATE_TOL, "parameters")


# ---------------------------------------------------------- capture audit

class HostRead(AssertionError):
    """A step read a device value on the host, or copied from the host."""


@contextlib.contextmanager
def capture_audit(monkeypatch):
    """What the card refuses under CUDA graph capture, made to raise, and
    the capture flag that ``ScheduledAdam`` reads set."""
    def refuse(name):
        def call(*args, **kwargs):
            raise HostRead(name)
        return call

    with monkeypatch.context() as m:
        for name in ("__bool__", "__float__", "__int__", "__index__", "item",
                     "tolist", "numpy", "cpu"):
            m.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        for name in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, name, refuse(f"torch.{name}"))
        m.setattr(state_module, "capturing", lambda: True)
        yield


def _python_state(obj, path="trainer", out=None, seen=None):
    """Every number, string, bool and None reachable through the
    attributes of the trainer's own objects (its modules, optimisers, mode
    context and augmentations), by path; tensors are the device's."""
    out = {} if out is None else out
    seen = set() if seen is None else seen
    if isinstance(obj, (bool, int, float, str, type(None))):
        out[path] = obj
        return out
    if id(obj) in seen:
        return out
    seen.add(id(obj))
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _python_state(v, f"{path}[{i}]", out, seen)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _python_state(v, f"{path}[{k!r}]", out, seen)
    elif isinstance(obj, torch.nn.Module):
        for k, v in vars(obj).items():
            if k not in ("_parameters", "_buffers"):
                _python_state(v, f"{path}.{k}", out, seen)
    elif type(obj).__module__.startswith("contrad_tpu_torch"):
        for k, v in vars(obj).items():
            _python_state(v, f"{path}.{k}", out, seen)
    return out


def _audited_runner(case):
    """A runner on ``case``'s trainer, its static row holding a batch's
    indices (and labels), warmed up by one eager step of each kind."""
    loader, trainer = _build(case)
    runner = BlockRunner(trainer, loader)
    idx, labels = loader.next_indices()
    runner._layout(len(idx))
    runner._row.copy_(torch.from_numpy(runner._pack([idx], [labels],
                                                    [0.99]))[0])
    kinds = ["plain", "r1"] if case == "stylegan2_tiny" else ["plain"]
    for kind in kinds:
        runner._graph_step(kind)
    return runner, kinds


def _counts():
    return {"blur": blur.blur2d.launches,
            "blur_scalar": blur.blur2d.scalar_launches}


@pytest.mark.parametrize("case", list(CASES))
def test_a_captured_step_reads_nothing_on_the_host(case, monkeypatch):
    runner, kinds = _audited_runner(case)
    trainer = runner.trainer
    for kind in kinds:
        before = dict(_python_state(trainer), **_counts())
        with capture_audit(monkeypatch):
            metrics = runner._graph_step(kind)
        assert dict(_python_state(trainer), **_counts()) == before, kind
        assert all(torch.isfinite(v) for v in metrics.values())
    # control: an eager step changes the Python-side state it mirrors
    before = _python_state(trainer)
    runner._graph_step("plain")
    changed = {k for k, v in _python_state(trainer).items()
               if before.get(k) != v}
    assert changed == {"trainer.g_tx.count", "trainer.d_tx.count"}


def test_the_host_drawn_jitter_order_fails_the_audit(monkeypatch):
    """Control: the jitter as it drew its order before (from a CPU
    generator, taken by a Python ``if``) runs eagerly but fails the
    audit."""
    host = torch.Generator().manual_seed(1)
    device_sample = ColorJitter.sample

    def host_sample(self, shape, rng):
        params = device_sample(self, shape, rng)
        params["contrast_first"] = bool(torch.rand((), generator=host) < 0.5)
        return params

    def host_apply(self, x, params):
        if params["contrast_first"]:
            return self._hsv(self._contrast(x, params), params)
        return self._contrast(self._hsv(x, params), params)

    monkeypatch.setattr(ColorJitter, "sample", host_sample)
    monkeypatch.setattr(ColorJitter, "apply", host_apply)
    runner, _ = _audited_runner("flagship")
    with pytest.raises(HostRead, match="__bool__"):
        with capture_audit(monkeypatch):
            runner._graph_step("plain")
