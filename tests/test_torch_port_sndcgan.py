"""The port's SNDCGAN modules (``contrad_tpu_torch/ops/spectral_norm.py``,
``models/sndcgan.py``, ``models/base.py``) against the JAX package on the
same weights and state (``contrad_tpu_torch/bridge.py``: parameters, G's
``batch_stats`` and D's ``spectral`` ``u`` vectors), at a narrow width:
16x16 images, ngf = ndf = 16, nz = 32, d_hidden = 64, batch 4.

Both packages run in float64 (JAX under ``jax.enable_x64``, its models with a
float64 compute dtype; the port's modules in double), as
``tests/test_torch_port_slice.py`` explains: in float32 a pre-activation
within rounding of a (leaky) ReLU kink takes the other slope in one of the
two programs. Where the JAX package computes in float32 on purpose even
then (G's tanh, the heads, the stored ``u``), it still does; the
tolerances cover that.

Checked: G in train mode (images and the batch-norm running statistics,
which flax moves with the BIASED batch variance) and in eval mode; D in
train and eval mode (score, penultimate features, both projections, and
every ``u`` after one and after two persisting forwards); that a
non-persisting pass leaves every ``u`` as it was; the spectral-norm layers
alone; the registry's initialisation.

Tolerances: forwards and state rtol 1e-4 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.models.sndcgan import DSndcgan as JaxD
from contrad_tpu.models.sndcgan import GSndcgan as JaxG
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan
from contrad_tpu_torch.ops.spectral_norm import commit_u
from torch_port_jax import one_torch_thread, t, to_np  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-6)
IMG, NGF, NDF, NZ, D_HIDDEN, N = (16, 16, 3), 16, 16, 32, 64, 4


def _f64(tree):
    """float32 leaves to float64; spectral norm's ``u`` stays float32, as
    the JAX package stores it."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def build_sndcgan_pair(seed=0):
    """The JAX G and D (float64 compute) with their variables (float64
    params and batch statistics, float32 ``u``), and a function that makes
    the port's twins in double holding the same state."""
    with jax.enable_x64(True):
        G = JaxG(IMG, ngf=NGF, nz=NZ, dtype=jnp.float64)
        D = JaxD(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN,
                 dtype=jnp.float64)
        kg, kd = jax.random.split(jax.random.PRNGKey(seed))
        # jitted: compiling each init once is quicker than op by op
        g_vars = jax.jit(lambda k: G.init(k, jnp.zeros((2, NZ)),
                                          train=True))(kg)
        d_vars = jax.jit(lambda k: D.init(k, jnp.zeros((2,) + IMG),
                                          train=True))(kd)
    g_vars = {"params": _f64(g_vars["params"]),
              "batch_stats": _f64(g_vars["batch_stats"])}
    d_vars = {"params": _f64(d_vars["params"]),
              "spectral": to_np(d_vars["spectral"])}

    def port(g_state=None, d_state=None):
        pg = GSndcgan(IMG, ngf=NGF, nz=NZ).double()
        pd = DSndcgan(IMG, ndf=NDF, d_hidden=D_HIDDEN).double()
        g = g_state or g_vars
        d = d_state or d_vars
        pg.load_state_dict(torch_state_dict(
            g["params"], {"batch_stats": g["batch_stats"]}), strict=True)
        pd.load_state_dict(torch_state_dict(
            d["params"], {"spectral": d["spectral"]}), strict=True)
        return pg, pd

    return G, D, g_vars, d_vars, port


@pytest.fixture(scope="module")
def pair():
    return build_sndcgan_pair()


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def _assert_state(module, jax_state, prefix=""):
    """Every buffer the bridge maps from ``jax_state`` equals the module's."""
    want = torch_state_dict({}, jax_state)
    have = module.state_dict()
    assert want, "no state to compare"
    for name, w in want.items():
        _close(have[name].numpy(), w.numpy(), prefix + name)


@pytest.mark.parametrize("train", [True, False])
def test_generator_matches_jax(pair, train):
    G, _, g_vars, _, port = pair
    z = np.random.default_rng(1).uniform(-1, 1, size=(N, NZ))
    with jax.enable_x64(True):
        if train:
            want, g_state = G.apply(g_vars, z, train=True,
                                    mutable=["batch_stats"])
        else:
            want = G.apply(g_vars, z, train=False)
    pg, _ = port()
    with torch.no_grad():
        got = pg(t(z), train=train)
    assert got.shape == (N,) + IMG
    _close(got.numpy(), want, "images")
    if train:
        _assert_state(pg, g_state)
    else:  # eval leaves the running statistics as they were
        _assert_state(pg, {"batch_stats": g_vars["batch_stats"]})


def test_generator_running_stats_move_twice_in_two_train_forwards(pair):
    G, _, g_vars, _, port = pair
    rng = np.random.default_rng(2)
    z1, z2 = (rng.uniform(-1, 1, size=(N, NZ)) for _ in range(2))
    variables = dict(g_vars)
    pg, _ = port()
    for z in (z1, z2):
        with jax.enable_x64(True):
            _, new = G.apply(variables, z, train=True, mutable=["batch_stats"])
        variables = dict(variables, **new)
        with torch.no_grad():
            pg(t(z), train=True)
    _assert_state(pg, {"batch_stats": variables["batch_stats"]})


def _d_outputs(d, aux):
    return {"score": d, **aux}


def test_discriminator_train_mode_and_its_u_after_two_forwards(pair):
    _, D, _, d_vars, port = pair
    rng = np.random.default_rng(3)
    xs = [rng.uniform(size=(N,) + IMG) for _ in range(2)]
    _, pd = port()
    variables = dict(d_vars)
    for i, x in enumerate(xs):
        with jax.enable_x64(True):
            (d, aux), new = D.apply(variables, x, train=True,
                                    mutable=["spectral"])
        variables = dict(variables, **new)
        with torch.no_grad():
            got = _d_outputs(*pd(t(x)))
        commit_u(pd)
        for k, v in _d_outputs(d, aux).items():
            _close(got[k].numpy(), v, f"forward {i + 1}: {k}")
        _assert_state(pd, {"spectral": variables["spectral"]},
                      f"u after forward {i + 1}: ")


def test_discriminator_eval_mode_matches_jax_and_keeps_u(pair):
    _, D, _, d_vars, port = pair
    x = np.random.default_rng(4).uniform(size=(N,) + IMG)
    with jax.enable_x64(True):
        d, aux = D.apply(d_vars, x, train=False)
    _, pd = port()
    with torch.no_grad():
        got = _d_outputs(*pd(t(x), train=False))
    commit_u(pd)
    for k, v in _d_outputs(d, aux).items():
        _close(got[k].numpy(), v, k)
    _assert_state(pd, {"spectral": d_vars["spectral"]})


def test_non_persisting_pass_iterates_but_leaves_u(pair):
    """``persist=False`` (the penalties' and R1's D passes): the output is a
    train-mode pass's (one power iteration), and no ``u`` moves."""
    _, D, _, d_vars, port = pair
    x = np.random.default_rng(5).uniform(size=(N,) + IMG)
    with jax.enable_x64(True):
        d, aux = D.apply(d_vars, x, train=True)  # no mutable collection
    _, pd = port()
    before = {k: v.clone() for k, v in pd.state_dict().items()
              if k.endswith(".u")}
    with torch.no_grad():
        got = _d_outputs(*pd(t(x), persist=False))
    commit_u(pd)
    for k, v in _d_outputs(d, aux).items():
        _close(got[k].numpy(), v, k)
    assert len(before) == 13  # 7 convs, 2 + 2 + 2 head layers
    for k, v in before.items():
        assert torch.equal(pd.state_dict()[k], v), k


def test_persisting_pass_stages_u_until_committed(pair):
    *_, port = pair
    _, pd = port()
    x = torch.rand(N, *IMG, dtype=torch.float64)
    u0 = pd.backbone.c3.u.clone()
    with torch.no_grad():
        pd(x)
        assert torch.equal(pd.backbone.c3.u, u0)  # staged, not yet written
        pd(x, persist=False)  # a penalty's pass reads the same stored u
    commit_u(pd)
    assert not torch.equal(pd.backbone.c3.u, u0)
    assert pd.backbone.c3.u_staged is None


@pytest.mark.parametrize("kind", ["dense", "conv"])
@pytest.mark.parametrize("train", [True, False])
def test_spectral_norm_layer_matches_jax(kind, train):
    from contrad_tpu.ops.spectral_norm import SNConv as JaxSNConv
    from contrad_tpu.ops.spectral_norm import SNDense as JaxSNDense
    from contrad_tpu_torch.ops.spectral_norm import SNConv, SNDense

    rng = np.random.default_rng(6)
    with jax.enable_x64(True):
        if kind == "dense":
            x = rng.normal(size=(3, 10))
            layer = JaxSNDense(7, dtype=jnp.float64)
            port = SNDense(10, 7).double()
        else:
            x = rng.normal(size=(2, 8, 8, 5))
            layer = JaxSNConv(6, (4, 4), strides=(2, 2), padding=1,
                              dtype=jnp.float64)
            port = SNConv(5, 6, 4, stride=2, padding=1).double()
        variables = layer.init(jax.random.PRNGKey(0), x)
        variables = {"params": _f64(variables["params"]),
                     "spectral": to_np(variables["spectral"])}
        want, new = layer.apply(variables, x, train=train,
                                mutable=["spectral"])
    port.load_state_dict(torch_state_dict(
        variables["params"], {"spectral": variables["spectral"]}))
    with torch.no_grad():
        xt = t(x) if kind == "dense" else t(x).permute(0, 3, 1, 2)
        got = port(xt, train=train)
        if kind == "conv":
            got = got.permute(0, 2, 3, 1)
    commit_u(port)
    _close(got.numpy(), want, "output")
    _close(port.u.numpy(), new["spectral"]["u"], "u")
    if not train:
        _close(port.u.numpy(), variables["spectral"]["u"], "u kept")


def test_registry_sndcgan_full_width_and_init():
    """The registry's sndcgan at full width has the JAX package's state
    (names, shapes), and its initialisation is the reference's: N(0, 0.02)
    weights, zero biases, batch norm at scale 1 / bias 0 with running
    statistics 0 / 1, and one unit-norm ``u`` per spectral-norm layer, each
    its own draw."""
    from contrad_tpu.models import get_architecture as jax_get_architecture
    from contrad_tpu_torch.models import get_architecture

    G, D = get_architecture("sndcgan", (32, 32, 3), device="cpu", seed=0)
    jg, jd = jax_get_architecture("sndcgan", (32, 32, 3))
    shapes = {}
    for m, x in ((jg, jnp.zeros((2, 128))), (jd, jnp.zeros((2, 32, 32, 3)))):
        tree = jax.eval_shape(lambda x, m=m: m.init(jax.random.PRNGKey(0), x,
                                                    train=True), x)
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
        shapes[m] = {k: tuple(v.shape) for k, v in torch_state_dict(
            zeros["params"],
            {c: v for c, v in zeros.items() if c != "params"}).items()}
    for port, m in ((G, jg), (D, jd)):
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} \
            == shapes[m]

    us = []
    for name, v in list(G.state_dict().items()) + list(D.state_dict().items()):
        if name.endswith(".u"):
            assert abs(float(v.norm()) - 1.0) < 1e-6, name
            us.append(v)
        elif name.endswith("running_mean") or name.endswith(".bias") \
                and "norm" in name:
            assert torch.count_nonzero(v) == 0, name
        elif name.endswith("running_var") or name.endswith(".weight") \
                and "norm" in name:
            assert torch.all(v == 1), name
        elif name.endswith(".bias"):
            assert torch.count_nonzero(v) == 0, name
        elif v.numel() >= 4096:
            assert abs(float(v.std()) - 0.02) < 0.002, name
            assert abs(float(v.mean())) < 0.002, name
    assert len(us) == 13
    same = [(a, b) for i, a in enumerate(us) for b in us[i + 1:]
            if a.shape == b.shape and torch.equal(a, b)]
    assert not same


def test_latent_is_uniform_in_minus_one_one():
    G = GSndcgan(IMG, ngf=NGF, nz=NZ)
    z = G.sample_latent(4096, torch.Generator().manual_seed(0))
    assert z.shape == (4096, NZ)
    assert float(z.min()) >= -1.0 and float(z.max()) < 1.0
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0 / 3.0) < 0.01  # U(-1, 1): variance 1/3
