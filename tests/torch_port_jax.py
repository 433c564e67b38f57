"""Shared helpers of the ``tests/test_torch_port_*.py`` parity tests: build a
JAX model and the port's twin with the same weights (through
``contrad_tpu_torch/bridge.py``), and reproduce from a JAX key the random
draws the JAX package makes, in the form the port takes them.

Each ``jax_*`` draw helper repeats the ``jax.random`` calls of the JAX code
it names, line for line, so that the port can be fed the same draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu_torch.bridge import torch_state_dict
from contrad_tpu_torch.models import get_architecture as port_get_architecture


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread: the suite runs several test processes
    side by side, and PyTorch's thread pool in each of them would otherwise
    take every core. Autouse in each module that imports it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def build_pair(arch, size, seed=0):
    """JAX (G, D, g_params, d_params) and the port's (G, D) on the CPU with
    the same weights."""
    G, D = jax_get_architecture(arch, (size, size, 3))
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    # jitted: compiling each init once is quicker than running it op by op
    g_params = jax.jit(lambda k, z: G.init({"params": k, "noise": k}, z,
                                           train=True)["params"])(
        kg, jnp.zeros((2, G.style_dim)))
    d_params = jax.jit(lambda k, x: D.init(k, x, train=True)["params"])(
        kd, jnp.zeros((2, size, size, 3)))
    pg, pd = port_get_architecture(arch, (size, size, 3), device="cpu")
    pg.load_state_dict(torch_state_dict(to_np(g_params)), strict=True)
    pd.load_state_dict(torch_state_dict(to_np(d_params)), strict=True)
    return G, D, g_params, d_params, pg, pd


def noise_list(G, n, seed):
    """Per-layer NHWC noise, numpy, in the shapes GStylegan2 draws."""
    rng = np.random.default_rng(seed)
    shapes = [(n, 4, 4, 1)]
    for i in range(3, G.log_size + 1):
        shapes += [(n, 2**i, 2**i, 1)] * 2
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def jax_mixing(G, variables, key, n, style_mix=0.9):
    """The style-mixing draws of ``GStylegan2.__call__``
    (generator.py:356-369) for ``rngs={'noise': key}``: the top module's
    first ``make_rng('noise')``, split three ways."""
    k = G.apply(variables, method=lambda m: m.make_rng("noise"),
                rngs={"noise": key})
    r_mix, r_layer, r_z = jax.random.split(k, 3)
    z_mix = jax.random.normal(r_z, (n, G.style_dim))
    nomix = jax.random.uniform(r_mix, (n,)) >= style_mix
    mix_layer = jax.random.randint(r_layer, (n,), 0, G.n_latent)
    mix_layer = jnp.where(nomix, G.n_latent, mix_layer)
    return t(z_mix), torch.from_numpy(np.asarray(mix_layer).astype(np.int64))


def jax_rrc_params(key, n, h, w, scale=(0.2, 1.0), ratio=(0.75, 4.0 / 3.0),
                   n_trials=10):
    """augment/spatial.py:113-144 (random_resize_crop)."""
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    r_area, r_aspect, r_bw, r_bh = jax.random.split(key, 4)
    area = float(h * w)
    target_area = jax.random.uniform(
        r_area, (n, n_trials), minval=scale[0], maxval=scale[1]) * area
    aspect = jnp.exp(jax.random.uniform(
        r_aspect, (n, n_trials), minval=log_ratio[0], maxval=log_ratio[1]))
    ww = jnp.round(jnp.sqrt(target_area * aspect))
    hh = jnp.round(jnp.sqrt(target_area / aspect))
    valid = (ww > 0) & (ww <= w) & (hh > 0) & (hh <= h)
    first = jnp.argmax(valid, axis=1)
    any_valid = jnp.any(valid, axis=1)
    ww_s = jnp.take_along_axis(ww, first[:, None], axis=1)[:, 0]
    hh_s = jnp.take_along_axis(hh, first[:, None], axis=1)[:, 0]
    span_w, span_h = w - ww_s, h - hh_s
    u_w = jax.random.uniform(r_bw, (n,))
    u_h = jax.random.uniform(r_bh, (n,))
    bias_w = (jnp.floor(u_w * (2.0 * span_w + 1.0)) - span_w) / w
    bias_h = (jnp.floor(u_h * (2.0 * span_h + 1.0)) - span_h) / h
    return {"sx": t(jnp.where(any_valid, ww_s / w, 1.0)),
            "sy": t(jnp.where(any_valid, hh_s / h, 1.0)),
            "bx": t(jnp.where(any_valid, bias_w, 0.0)),
            "by": t(jnp.where(any_valid, bias_h, 0.0))}


def jax_flip_params(key, n):
    """augment/spatial.py:43-45 (horizontal_flip)."""
    return {"flip": t(jax.random.bernoulli(key, 0.5, (n, 1, 1, 1))[:, 0, 0, 0])}


def jax_jitter_params(key, n, b=(0.6, 1.4), c=(0.6, 1.4), s=(0.6, 1.4),
                      h=(-0.1, 0.1)):
    """augment/color.py:127-165 (color_jitter with the default ranges)."""
    r_order, r_c, r_hsv = jax.random.split(key, 3)
    r_h, r_s, r_v = jax.random.split(r_hsv, 3)
    return {
        "contrast_first": bool(jax.random.bernoulli(r_order, 0.5)),
        "contrast": t(jax.random.uniform(r_c, (n, 1, 1, 1), minval=c[0],
                                         maxval=c[1])[:, 0, 0, 0]),
        "f_h": t(jax.random.uniform(r_h, (n, 1, 1), minval=h[0],
                                    maxval=h[1])[:, 0, 0]),
        "f_s": t(jax.random.uniform(r_s, (n, 1, 1), minval=s[0],
                                    maxval=s[1])[:, 0, 0]),
        "f_v": t(jax.random.uniform(r_v, (n, 1, 1), minval=b[0],
                                    maxval=b[1])[:, 0, 0]),
    }


def jax_random_apply_mask(key, n, p):
    """augment/__init__.py:51-52 (random_apply): (mask, inner key)."""
    r_mask, r_fn = jax.random.split(key)
    mask = jax.random.bernoulli(r_mask, p, (n, 1, 1, 1))[:, 0, 0, 0]
    return t(mask), r_fn


def jax_simclr_params(key, n, h, w):
    """Parameters of ``get_augment('simclr')(key, x)`` for an (n, h, w, 3)
    batch, in the port's ``Compose`` layout (compose folds in the stage
    index, augment/__init__.py:59-62)."""
    k = [jax.random.fold_in(key, i) for i in range(4)]
    jmask, jkey = jax_random_apply_mask(k[2], n, 0.8)
    gmask, _ = jax_random_apply_mask(k[3], n, 0.2)
    return [jax_rrc_params(k[0], n, h, w), jax_flip_params(k[1], n),
            {"mask": jmask, "inner": jax_jitter_params(jkey, n)},
            {"mask": gmask, "inner": {}}]
