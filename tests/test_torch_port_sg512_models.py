"""The 512x512 recipe's StyleGAN2 (``stylegan2_512``) in the port against
the JAX package's packed path. The JAX package lays its shallowest levels
out space-to-depth (``contrad_tpu/ops/packed.py``): D's stem where the top
level has at most 32 channels, G's levels with at most 64, so at
``channel_multiplier`` 1.0 and 512x512 both pack. The port runs the same
function unpacked. The packing depends only on the channel map, so it is
held here at 128x128 with ``channel_multiplier`` 0.25
(``stylegan2_tiny``'s width), where both pack as well: the port's G and D
against JAX's packed ones (the default ``pack_top`` / ``pack_stem``), on
the same weights (``contrad_tpu_torch/bridge.py``), noise and style
mixing, in forward and in gradients, batch 2. Then ``stylegan2_512``'s
full-width parameter tree carries over leaf for leaf.

Float64 in both packages (JAX under ``jax.enable_x64`` with a float64
compute dtype, the port's modules in double), as
``tests/test_torch_port_slice.py`` compares: in float32 the gradients are
sums over 16k-65k pixels per image whose terms largely cancel, and the
leaky-ReLU kinks that the two programs' roundings flip move single
elements of a gradient by percents. D is float64 throughout, so each of
its elements is held to rtol 1e-3 / atol 1e-5 (gradients) and rtol 1e-4 /
atol 1e-5 (forwards). JAX's G computes every ``ModulatedConv``'s
modulation in float32 even so (the style and the modulation weights
rounded to float32, ``contrad_tpu/models/stylegan2/generator.py:81-83``):
its image moves by up to 1.5e-6, and the kinks that moves flip shift
single gradient elements of the 8x8-32x32 levels. So G's image is held to
rtol 1e-4 / atol 1e-5 and each of its gradients to max|port - JAX| <=
1e-5 + 1e-3 max|JAX| with at most 2 % of its elements off by over 1 %
(:func:`assert_close_to_scale`; measured 3.6e-4 of the max and 1.4 %).
XLA's float64 convolutions on the CPU take about 25 s per image for D's
forward and backward here, hence batch 2 and D's test in a file of its
own (``tests/test_torch_port_sg512_dmodel.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models import get_architecture
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    build_pair, jax_mixing, noise_list, one_torch_thread, t, to_np)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
G_GRAD_TOL = dict(frac=1e-3, share=0.02)  # assert_close_to_scale's bounds
ARCH, SIZE, N = "stylegan2_tiny", 128, 2


def pair128_f64(seed: int):
    """JAX's packed G and D in float64 (models and parameters) and the
    port's in double, on the same weights."""
    _, _, g_params, d_params, pg, pd = build_pair(ARCH, SIZE, seed=seed)
    with jax.enable_x64(True):
        G, D = jax_get_architecture(ARCH, (SIZE, SIZE, 3), dtype=jnp.float64)
        assert G.packed_io == 2 and D.backbone.packed_io == 2  # both pack
        g_params, d_params = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), (g_params, d_params))
    return G, D, g_params, d_params, pg.double(), pd.double()


def assert_grads(got_grads, names, want_grads):
    """Each of the port's gradients (in ``names`` order) against JAX's,
    element by element."""
    want = torch_state_dict(to_np(want_grads))
    assert set(names) == set(want)
    for name, g in zip(names, got_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def assert_close_to_scale(got, want, what, frac, share):
    """max|got - want| <= 1e-5 + ``frac`` max|want|, and at most a
    ``share`` of the elements beyond rtol 1e-2 / atol 1e-5 of their own
    value: the bound for a gradient whose single elements the leaky-ReLU
    kinks move."""
    err = np.abs(got - want)
    limit = 1e-5 + frac * float(np.abs(want).max())
    assert err.max() <= limit, f"{what}: max|port - JAX| {err.max()} > {limit}"
    off = float(np.mean(err > 1e-5 + 1e-2 * np.abs(want)))
    assert off <= share, f"{what}: {off:.2%} of the elements off by over 1 %"


def test_generator_and_its_gradients_match_jax_packed():
    G, _, g_params, _, pg, _ = pair128_f64(seed=2)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(N, G.style_dim))
    noise = [a.astype(np.float64) for a in noise_list(G, N, 4)]
    w = rng.normal(size=(N, SIZE, SIZE, 3))
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(3)
        mixing = jax_mixing(G, {"params": g_params}, key, N)

        def loss(params):
            img = G.apply({"params": params}, jnp.asarray(z), train=True,
                          style_mix=0.9,
                          noise=[jnp.asarray(a) for a in noise],
                          rngs={"noise": key})
            return jnp.sum(img * w), img

        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            g_params)
    assert mixing[0].dtype == torch.float64
    img = pg(t(z), [t(a) for a in noise], mixing, train=True)
    got_grads = torch.autograd.grad((img * t(w)).sum(), list(pg.parameters()))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    want = torch_state_dict(to_np(grads))
    names = [k for k, _ in pg.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, got_grads, strict=True):
        assert_close_to_scale(g.numpy(), want[name].numpy(), name, **G_GRAD_TOL)


def test_stylegan2_512_parameters_carry_over_leaf_for_leaf():
    """Every leaf of the JAX package's ``stylegan2_512`` at (512, 512, 3)
    (shapes from ``jax.eval_shape`` of its init, the packed modules
    included) maps to a parameter of the port's of the same shape, and no
    parameter of the port is left out."""
    G, D = jax_get_architecture("stylegan2_512", (512, 512, 3))
    key = jax.random.PRNGKey(0)
    g_shapes = jax.eval_shape(
        lambda k: G.init({"params": k, "noise": k},
                         jnp.zeros((2, G.style_dim)), train=True), key)
    d_shapes = jax.eval_shape(
        lambda k: D.init(k, jnp.zeros((2, 512, 512, 3)), train=True), key)
    pg, pd = get_architecture("stylegan2_512", (512, 512, 3), device="cpu")
    for shapes, module in ((g_shapes, pg), (d_shapes, pd)):
        assert set(shapes) == {"params"}  # no batch statistics, no u
        leaves = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                              dict(shapes["params"]))
        mapped = torch_state_dict(leaves)
        have = dict(module.named_parameters())
        assert len(mapped) == len(jax.tree.leaves(leaves)) == len(have)
        assert set(mapped) == set(have)
        for name, value in mapped.items():
            assert tuple(value.shape) == tuple(have[name].shape), name
    # full width: 32 channels at 512x512, 512 from 32x32 down
    assert pg.to_rgbs[-1].conv.weight.shape == (3, 32, 1, 1)
    assert pd.backbone.from_rgb.conv.conv.weight.shape == (32, 3, 1, 1)
    assert pd.backbone.last_conv.conv.weight.shape == (512, 513, 3, 3)
