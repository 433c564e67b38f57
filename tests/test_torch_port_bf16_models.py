"""The port's models and augment modes under a bfloat16 compute dtype
(``get_architecture(..., dtype=torch.bfloat16)``, ``contrad_tpu_torch/
models``, ``augment``) against the JAX package's with ``dtype=
jnp.bfloat16``, on the same float32 parameters and state (through
``contrad_tpu_torch/bridge.py``) and the same inputs from a numpy seed, at
narrow widths: SNDCGAN at 16x16 (ngf = ndf = 16, nz = 32, d_hidden = 64,
batch 4), ``snresnet18``'s D at 32x32 (its fixed widths, d_hidden = 64,
batch 2) and ``stylegan2_tiny`` at 16x16 (batch 4).

Checked: G in train mode (bfloat16 images; SNDCGAN's batch-norm running
statistics, float32) and in eval mode (float32 images); D's score,
penultimate features and both projections (float32, the heads' dtype) and
spectral norm's ``u`` (float32) after a persisting forward; every augment
mode of the registry on bfloat16 images (bfloat16 out, values against
JAX's); and the dtypes at JAX's cast points. That audit is made per layer:
every flax module's output dtype in a forward (read with
``flax.linen.intercept_methods``) against the port's module of the same
name (forward hooks; ``bridge.py``'s names), so a layer that computes in
float32 where JAX's computes in bfloat16, or the reverse, fails it (shown
by a control: SNDCGAN D with one conv in float32). Modules the port applies
through ``torch.nn.functional`` are listed as such in each test.
``NoiseInjection`` (one scalar strength a layer) is held on its own, its
strength's gradient taken from an upstream gradient that follows the noise,
so that the sum is not cancelled to rounding as it is in a GAN step.

Tolerances: ``|port - jax| <= 3e-2 * max|jax|`` for every forward, state
included. XLA on the CPU keeps float32 inside its fusions where the port
rounds each op's bfloat16 result, and JAX folds the blur into the
neighbouring conv where the port rounds between them; a bfloat16 ulp is
2^-8 relative. The augment modes ``5e-2 * max|jax|``: their HSV jitter is a
chain of some twenty bfloat16 ops (atan2, remainders, clamps), where JAX's
own bfloat16 result lies 7.2e-2 from its float32 result on this batch
(color_jitter; 3.1e-2 for simclr) and the port's 4.3e-2 from JAX's.
The noise strength's gradient, a sum of bfloat16 products over the layer's
output: within ``2^-8 * sum|g * noise|`` (what rounding each product, or
the result, to bfloat16 can move it; here 2^-8 of the value itself) of the
exact sum of those products, taken in float64; JAX's own lies 3.6 % from
that sum (XLA on the CPU accumulates bfloat16 sums in bfloat16), and the
port is held to JAX within that distance plus the bound.
"""

import copy
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.augment import get_augment as jax_get_augment
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu.models.sndcgan import DSndcgan as JaxD
from contrad_tpu.models.sndcgan import GSndcgan as JaxG
from contrad_tpu.models.snresnet import DSnresnet18 as JaxResD
from contrad_tpu.models.stylegan2.generator import \
    NoiseInjection as JaxNoiseInjection
from contrad_tpu_torch.augment import get_augment
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models import get_architecture
from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan
from contrad_tpu_torch.models.snresnet import DSnresnet18
from contrad_tpu_torch.models.stylegan2.generator import NoiseInjection
from test_torch_port_augment_modes import HQ, JAX_MODES
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    _jitter_ranges, jax_cutout_params, jax_diffaug_params, jax_flip_params,
    jax_hfrt_params, jax_jitter_params, jax_simclr_params, noise_list,
    one_torch_thread, t, to_np)

REL = 3e-2
AUG_REL = 5e-2
BF = jnp.bfloat16
IMG, NGF, NDF, NZ, D_HIDDEN, N = (16, 16, 3), 16, 16, 32, 64, 4


def assert_close(got, want, what, rel=REL):
    """``|got - want| <= rel * max|want|`` elementwise, in float32."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, \
        f"{what}: max|port - jax| {err} > {rel} * {scale}"


_LISTS = re.compile(r"^(style|layers|to_rgbs)_(\d+)$")  # bridge.py's


def jax_layer_dtypes(fn):
    """{module name: set of output dtypes} over every flax module called
    in ``fn()`` (traced abstractly, not run), in the port's names."""
    log = {}

    def record(call, args, kwargs, context):
        out = call(*args, **kwargs)
        if context.method_name == "__call__" and hasattr(out, "dtype"):
            name = ".".join(_LISTS.sub(r"\1.\2", p)
                            for p in context.module.path)
            log.setdefault(name, set()).add(str(out.dtype))
        return out

    with fnn.intercept_methods(record):
        jax.eval_shape(fn)
    return log


def port_layer_dtypes(module, fn):
    """{module name: set of output dtypes} over every submodule of
    ``module`` called in ``fn()``."""
    log, hooks = {}, []
    for name, m in module.named_modules():
        def record(_, __, out, name=name):
            if isinstance(out, torch.Tensor):
                log.setdefault(name, set()).add(
                    str(out.dtype).replace("torch.", ""))
        hooks.append(m.register_forward_hook(record))
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return log


def assert_layer_dtypes(want, got, functional=()):
    """Every JAX module's output dtype is the port's module's of the same
    name; ``functional`` names the modules the port applies through
    ``torch.nn.functional`` (no module call to hook)."""
    assert set(want) - set(got) == set(functional), \
        (sorted(set(want) - set(got)), functional)
    assert sum("bfloat16" in d for d in want.values()) >= 2, want
    wrong = {k: (w, got[k]) for k, w in want.items() if k in got
             and got[k] != w}
    assert not wrong, f"layer dtypes (jax, port): {wrong}"


def bf16_pair(x):
    """The same bfloat16 values for both packages (both round to nearest)."""
    return jnp.asarray(x, BF), torch.from_numpy(np.asarray(x, np.float32)
                                                ).bfloat16()


def _load(module, params, state=None):
    module.load_state_dict(torch_state_dict(to_np(params), to_np(state or {})),
                           strict=True)
    return module


@pytest.fixture(scope="module")
def sndcgan():
    G = JaxG(IMG, ngf=NGF, nz=NZ, dtype=BF)
    D = JaxD(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN, dtype=BF)
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    g_vars = jax.jit(lambda k: G.init(k, jnp.zeros((2, NZ)), train=True))(kg)
    d_vars = jax.jit(lambda k: D.init(k, jnp.zeros((2,) + IMG),
                                      train=True))(kd)
    pg = _load(GSndcgan(IMG, ngf=NGF, nz=NZ, dtype=torch.bfloat16),
               g_vars["params"], {"batch_stats": g_vars["batch_stats"]})
    pd = _load(DSndcgan(IMG, ndf=NDF, mlp_linear=True, d_hidden=D_HIDDEN,
                        dtype=torch.bfloat16),
               d_vars["params"], {"spectral": d_vars["spectral"]})
    return G, D, g_vars, d_vars, pg, pd


@pytest.mark.parametrize("train", [True, False])
def test_sndcgan_generator_bf16_matches_jax(sndcgan, train):
    G, _, g_vars, _, pg, _ = sndcgan
    pg_audit = copy.deepcopy(pg)  # its batch norms move in train mode
    z = np.random.default_rng(1).uniform(-1, 1, size=(N, NZ)).astype(
        np.float32)
    if train:
        want, g_state = G.apply(g_vars, jnp.asarray(z), train=True,
                                mutable=["batch_stats"])
    else:
        want = G.apply(g_vars, jnp.asarray(z), train=False)
    with torch.no_grad():
        got = pg(t(z), train=train)
    # G emits the compute dtype in training and float32 in eval
    assert want.dtype == (BF if train else jnp.float32)
    assert got.dtype == (torch.bfloat16 if train else torch.float32)
    assert_close(got, want, "images")
    assert_layer_dtypes(
        jax_layer_dtypes(lambda: G.apply(g_vars, jnp.asarray(z), train=train,
                                         mutable=["batch_stats"])),
        port_layer_dtypes(pg_audit, lambda: pg_audit(t(z), train=train)),
        functional={"linear", "up0", "up1", "up2", "to_rgb"})
    if train:
        have = pg.state_dict()
        for name, w in torch_state_dict({}, to_np(g_state)).items():
            assert have[name].dtype == torch.float32, name
            assert_close(have[name], w, name)


def _d_outputs(D, d_vars, x):
    (d, aux), state = D.apply(d_vars, x, train=True, mutable=["spectral"])
    return (d, aux), state


def _check_d(pd, x_port, want, state):
    (d, aux) = want
    got_d, got_aux = pd(x_port)
    for name, w, g in (("d", d, got_d),
                       *((k, aux[k], got_aux[k]) for k in
                         ("penultimate", "projection", "projection2"))):
        assert w.dtype == jnp.float32 and g.dtype == torch.float32, name
        assert_close(g.detach(), w, name)
    from contrad_tpu_torch.ops.spectral_norm import commit_u

    commit_u(pd)
    have = pd.state_dict()
    for name, w in torch_state_dict({}, to_np(state)).items():
        assert have[name].dtype == torch.float32, name
        assert_close(have[name], w, name)
    assert all(p.dtype == torch.float32 for p in pd.parameters())


def _d_layer_dtypes(D, variables, pd, x_jax, x_port):
    pd = copy.deepcopy(pd)  # the forward moves spectral norm's u
    return (jax_layer_dtypes(lambda: D.apply(variables, x_jax, train=True,
                                             mutable=["spectral"])),
            port_layer_dtypes(pd, lambda: pd(x_port)))


def test_sndcgan_discriminator_bf16_matches_jax(sndcgan):
    _, D, _, d_vars, _, pd = sndcgan
    x_jax, x_port = bf16_pair(np.random.default_rng(2).uniform(
        size=(N,) + IMG))
    want, state = _d_outputs(D, d_vars, x_jax)
    assert_layer_dtypes(*_d_layer_dtypes(D, d_vars, pd, x_jax, x_port))
    _check_d(copy.deepcopy(pd), x_port, want, state)


def test_layer_dtype_audit_catches_a_float32_layer(sndcgan):
    """The control: the flagship D with its fourth conv computing in
    float32 (its gradients stay within bfloat16's noise of JAX's, so the
    step's gradient check cannot see it) fails the per-layer audit."""
    _, D, _, d_vars, _, pd = sndcgan
    pd = copy.deepcopy(pd)
    pd.backbone.c3.dtype = torch.float32
    x_jax, x_port = bf16_pair(np.random.default_rng(2).uniform(
        size=(N,) + IMG))
    with pytest.raises(AssertionError, match="backbone.c3"):
        assert_layer_dtypes(*_d_layer_dtypes(D, d_vars, pd, x_jax, x_port))


def test_snresnet18_discriminator_bf16_matches_jax():
    img = (32, 32, 3)
    D = JaxResD(mlp_linear=True, d_hidden=D_HIDDEN, dtype=BF)
    d_vars = jax.jit(lambda k: D.init(k, jnp.zeros((2,) + img), train=True))(
        jax.random.PRNGKey(3))
    pd = _load(DSnresnet18(mlp_linear=True, d_hidden=D_HIDDEN,
                           dtype=torch.bfloat16),
               d_vars["params"], {"spectral": d_vars["spectral"]})
    x_jax, x_port = bf16_pair(np.random.default_rng(4).uniform(
        size=(2,) + img))
    want, state = jax.jit(lambda v, x: _d_outputs(D, v, x))(d_vars, x_jax)
    assert_layer_dtypes(*_d_layer_dtypes(D, d_vars, pd, x_jax, x_port))
    _check_d(pd, x_port, want, state)


@pytest.fixture(scope="module")
def tiny():
    size = 16
    G, D = jax_get_architecture("stylegan2_tiny", (size, size, 3), dtype=BF)
    kg, kd = jax.random.split(jax.random.PRNGKey(5))
    g_params = jax.jit(lambda k, z: G.init({"params": k, "noise": k}, z,
                                           train=True)["params"])(
        kg, jnp.zeros((2, G.style_dim)))
    d_params = jax.jit(lambda k, x: D.init(k, x, train=True)["params"])(
        kd, jnp.zeros((2, size, size, 3)))
    pg, pd = get_architecture("stylegan2_tiny", (size, size, 3),
                              device="cpu", dtype=torch.bfloat16)
    return G, D, g_params, d_params, _load(pg, g_params), _load(pd, d_params)


@pytest.mark.parametrize("train", [True, False])
def test_stylegan2_tiny_generator_bf16_matches_jax(tiny, train):
    G, _, g_params, _, pg, _ = tiny
    z = np.random.default_rng(6).normal(size=(N, G.style_dim)).astype(
        np.float32)
    noise = noise_list(pg, N, seed=7)
    want = jax.jit(lambda p, z, nz: G.apply(
        {"params": p}, z, train=train, style_mix=0.0, noise=nz))(
        g_params, jnp.asarray(z), [jnp.asarray(a) for a in noise])
    with torch.no_grad():
        got = pg(t(z), [t(a) for a in noise], None, train=train)
    assert want.dtype == (BF if train else jnp.float32)
    assert got.dtype == (torch.bfloat16 if train else torch.float32)
    assert_close(got, want, "images")
    assert_layer_dtypes(
        jax_layer_dtypes(lambda: G.apply(
            {"params": g_params}, jnp.asarray(z), train=train, style_mix=0.0,
            noise=[jnp.asarray(a) for a in noise])),
        port_layer_dtypes(pg, lambda: pg(t(z), [t(a) for a in noise], None,
                                         train=train)),
        functional={"pixel_norm"})


def test_stylegan2_tiny_discriminator_bf16_matches_jax(tiny):
    _, D, _, d_params, _, pd = tiny
    x_jax, x_port = bf16_pair(np.random.default_rng(8).uniform(
        size=(N, 16, 16, 3)))
    d, aux = jax.jit(lambda p, x: D.apply({"params": p}, x, train=True))(
        d_params, x_jax)
    assert_layer_dtypes(*_d_layer_dtypes(D, {"params": d_params}, pd, x_jax,
                                         x_port))
    _check_d(pd, x_port, (d, aux), {})


@pytest.mark.parametrize("strength", [0.0, 0.25])
def test_noise_injection_bf16_matches_jax(strength):
    """``x + strength * noise`` on a bfloat16 x (float32 strength and
    noise): the output, and the gradients of x and of the strength under
    an upstream gradient that follows the noise."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, 8, 8, 16))
    noise = rng.normal(size=(N, 8, 8, 1)).astype(np.float32)
    up = (noise + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    x_jax, x_port = bf16_pair(x)

    def jax_loss(params, x):
        y = JaxNoiseInjection().apply({"params": params}, x,
                                      jnp.asarray(noise))
        return jnp.sum(y.astype(jnp.float32) * up), y

    params = {"weight": jnp.float32(strength)}
    (_, want), (g_w, g_x) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, x_jax)
    module = NoiseInjection()
    with torch.no_grad():
        module.weight.fill_(strength)
    x_port.requires_grad_(True)
    got = module(x_port, t(noise))
    (got.float() * t(up)).sum().backward()
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    assert_close(got.detach(), want, "output")
    assert x_port.grad.dtype == torch.bfloat16 and g_x.dtype == BF
    assert_close(x_port.grad, g_x, "x gradient")
    # the exact sum of the bfloat16 products (the cast's adjoint rounds
    # the upstream gradient to bfloat16, the noise is rounded to it)
    g_y = np.asarray(jnp.asarray(up, BF), np.float64)
    products = g_y * np.asarray(jnp.asarray(noise, BF), np.float64)
    exact, bound = float(products.sum()), 2.0 ** -8 * float(
        np.abs(products).sum())
    assert abs(exact) > 100 * bound  # the sum is not cancelled to rounding
    w, g = float(g_w["weight"]), float(module.weight.grad)
    assert module.weight.grad.dtype == torch.float32
    assert abs(g - exact) <= bound, f"strength gradient: port {g}, {exact}"
    # XLA on the CPU sums the bfloat16 products in bfloat16: JAX's lies
    # 3.6 % from the exact sum here (3888 against 4033.7), nine times the
    # rounding bound; the port is no further from it than that
    assert abs(g - w) <= abs(w - exact) + bound, f"port {g}, jax {w}"


def _mode_params(mode, key, x):
    """The parameters JAX's ``get_augment(mode, HQ)`` draws from ``key`` for
    a bfloat16 batch ``x``, in the port's form."""
    n, h, w, _ = x.shape
    if mode == "none":
        return None
    if mode == "gaussian":  # drawn in the images' dtype (color.py:217)
        noise = jax.random.normal(key, x.shape, dtype=x.dtype)
        return {"noise": torch.from_numpy(np.asarray(noise, np.float32)
                                          ).bfloat16()}
    if mode == "hflip":
        return jax_flip_params(key, n)
    if mode == "hfrt":
        return jax_hfrt_params(key, n, 4)
    if mode == "color_jitter":
        return jax_jitter_params(key, n, **_jitter_ranges(HQ))
    if mode == "cutout":
        return jax_cutout_params(key, n, h, w)
    if mode == "diffaug":
        return jax_diffaug_params(key, "color,cutout", x.shape)
    return jax_simclr_params(key, n, h, w, mode, HQ)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_every_augment_mode_keeps_bf16_and_matches_jax(mode):
    x_jax, x_port = bf16_pair(np.random.default_rng(9).uniform(
        size=(4, 20, 20, 3)))
    key = jax.random.PRNGKey(10)
    want = jax_get_augment(mode, HQ)(key, x_jax)
    got = get_augment(mode, HQ).apply(x_port, _mode_params(mode, key, x_jax))
    assert want.dtype == BF and got.dtype == torch.bfloat16, mode
    assert_close(got, want, mode, rel=AUG_REL)
