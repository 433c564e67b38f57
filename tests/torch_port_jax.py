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
    """augment/color.py:127-165 (color_jitter with the default ranges);
    the order as the bool tensor the port's jitter draws on the device."""
    r_order, r_c, r_hsv = jax.random.split(key, 3)
    r_h, r_s, r_v = jax.random.split(r_hsv, 3)
    return {
        "contrast_first": torch.tensor(bool(
            jax.random.bernoulli(r_order, 0.5))),
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


def jax_random_crop_params(key, n, max_pixels):
    """augment/spatial.py:80-82 (random_crop)."""
    return {"bias": t(jax.random.randint(key, (n, 2), -max_pixels,
                                         max_pixels + 1)).long()}


def jax_hfrt_params(key, n, max_pixels):
    """augment/spatial.py:62-67 (hflip_random_crop)."""
    r_flip, r_bias = jax.random.split(key)
    return dict(jax_random_crop_params(r_bias, n, max_pixels),
                flip=t(jax.random.bernoulli(r_flip, 0.5, (n,))))


def jax_cutout_params(key, n, h, w):
    """augment/spatial.py:166-168 (cutout)."""
    r_h, r_w = jax.random.split(key)
    return {"hc": t(jax.random.randint(r_h, (n, 1, 1), 0, h)[:, 0, 0]).long(),
            "wc": t(jax.random.randint(r_w, (n, 1, 1), 0, w)[:, 0, 0]).long()}


def jax_noise_params(key, shape):
    """augment/color.py:195 (gaussian_noise)."""
    return {"noise": t(jax.random.normal(key, shape))}


def jax_blur_params(key, sigma_range=(0.1, 2.0)):
    """augment/color.py:224-225 (gaussian_blur): one sigma per batch."""
    return {"sigma": t(jax.random.uniform(key, (), minval=sigma_range[0],
                                          maxval=sigma_range[1]))}


def jax_diffaug_params(key, policy, shape):
    """augment/diffaug.py (diff_augment): one parameter set per op of the
    chain, each op drawing from ``fold_in(key, its index)``."""
    n, h, w = shape[0], shape[1], shape[2]
    names = [p for p in policy.split(",") if p]
    ops = [op for p in names for op in {
        "color": ("brightness", "saturation", "contrast"),
        "translation": ("translation",), "cutout": ("cutout",)}[p]]
    out = []
    for i, op in enumerate(ops):
        k = jax.random.fold_in(key, i)
        if op in ("brightness", "saturation", "contrast"):
            out.append({"u": t(jax.random.uniform(k, (n, 1, 1, 1))[:, 0, 0, 0])})
        elif op == "translation":
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            r_h, r_w = jax.random.split(k)
            out.append({
                "th": t(jax.random.randint(r_h, (n, 1, 1), -sh, sh + 1)[:, 0, 0]).long(),
                "tw": t(jax.random.randint(r_w, (n, 1, 1), -sw, sw + 1)[:, 0, 0]).long()})
        else:
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            r_h, r_w = jax.random.split(k)
            out.append({
                "off_h": t(jax.random.randint(
                    r_h, (n, 1, 1), 0, h + (1 - ch % 2))[:, 0, 0]).long(),
                "off_w": t(jax.random.randint(
                    r_w, (n, 1, 1), 0, w + (1 - cw % 2))[:, 0, 0]).long()})
    return out


def _jitter_ranges(hyper):
    from contrad_tpu.augment.color import _check_range

    j = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1,
         **(hyper or {}).get("color_jitter", {})}
    return dict(b=_check_range(j["brightness"], "brightness"),
                c=_check_range(j["contrast"], "contrast"),
                s=_check_range(j["saturation"], "saturation"),
                h=_check_range(j["hue"], "hue", center=0.0, bound=(-0.5, 0.5),
                               clip_first_on_zero=False))


def jax_simclr_params(key, n, h, w, mode="simclr", hyper=None):
    """Parameters of ``get_augment(mode, hyper)(key, x)`` for an (n, h, w, 3)
    batch, ``mode`` one of ``simclr``, ``simclr_hq``, ``simclr_hq_cutout``,
    ``hyper`` a config's [augment] table (rrc, color_jitter, blur, cutout;
    the defaults otherwise), in the port's ``Compose`` layout (compose folds
    in the stage index, augment/__init__.py:59-62)."""
    hyper = hyper or {}
    n_stages = {"simclr": 4, "simclr_hq": 5, "simclr_hq_cutout": 6}[mode]
    k = [jax.random.fold_in(key, i) for i in range(n_stages)]
    scale = tuple(hyper.get("rrc", {}).get("scale", (0.2, 1.0)))
    jmask, jkey = jax_random_apply_mask(k[2], n, 0.8)
    gmask, _ = jax_random_apply_mask(k[3], n, 0.2)
    params = [jax_rrc_params(k[0], n, h, w, scale=scale),
              jax_flip_params(k[1], n),
              {"mask": jmask, "inner": jax_jitter_params(
                  jkey, n, **_jitter_ranges(hyper))},
              {"mask": gmask, "inner": {}}]
    if n_stages > 4:
        bmask, bkey = jax_random_apply_mask(k[4], n, 0.5)
        sigma_range = tuple(hyper.get("blur", {}).get("sigma_range",
                                                      (0.1, 2.0)))
        params.append({"mask": bmask,
                       "inner": jax_blur_params(bkey, sigma_range)})
    if n_stages > 5:
        cmask, ckey = jax_random_apply_mask(k[5], n, 0.5)
        params.append({"mask": cmask,
                       "inner": jax_cutout_params(ckey, n, h, w)})
    return params


def jax_fake_labels(key, n, n_critic, n_classes, real_flip=False):
    """The fake labels of a conditional ``GANTrainer._step``
    (step.py:202-216, :266-271) from the state's key: one vector per D
    sub-step, then the G phase's, as the port's ``StepDraws.y_gen``."""
    rng, out = key, []
    if real_flip:
        rng, _ = jax.random.split(rng)
    for _ in range(n_critic):  # _d_substep
        rng, _, _, _, y_rng = jax.random.split(rng, 5)
        out.append(jax.random.randint(y_rng, (n,), 0, n_classes))
    rng, _, _, _, y_rng, _ = jax.random.split(rng, 6)
    out.append(jax.random.randint(y_rng, (n,), 0, n_classes))
    return [torch.from_numpy(np.asarray(y).astype(np.int64)) for y in out]
