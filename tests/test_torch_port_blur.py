"""The port's blur (``contrad_tpu_torch/ops/blur.py``) against the JAX
package: the XLA composite ``ops/upfirdn2d.py::blur2d`` and the Pallas kernel
``ops/pallas_blur.py::pallas_blur2d`` (interpret mode, as
``tests/test_stylegan2.py`` runs it). On the CPU the port runs its plain
version; the CUDA kernel is held to that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``.

Tolerances: f32 sums of 16 products of O(1) values in another order differ
by a few ulps, so rtol 1e-5 / atol 1e-5 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrad_tpu.ops.upfirdn2d import blur2d as jax_blur2d
from contrad_tpu.ops.upfirdn2d import make_kernel as jax_make_kernel
from contrad_tpu_torch.ops import blur as port_blur
from contrad_tpu_torch.ops.upfirdn2d import blur2d as port_blur2d
from contrad_tpu_torch.ops.upfirdn2d import blur_taps, make_kernel

TOL = dict(rtol=1e-5, atol=1e-5)
# (pad, upsample_factor): D's downsample blurs (3x3 and 1x1 convs), G's
# post-upsample blur, and the adjoint pads their backward uses
CASES = [((2, 2), 1), ((1, 1), 1), ((1, 1), 2), ((0, 3), 1), ((3, 0), 2)]


def _jax_fn(pad, up):
    k = jax_make_kernel([1, 3, 3, 1])
    return lambda x: jax_blur2d(x, k, pad, upsample_factor=up)


def _port(x, pad, up):
    return port_blur2d(x, make_kernel([1, 3, 3, 1]), pad, upsample_factor=up)


@pytest.mark.parametrize("pad,up", CASES)
@pytest.mark.parametrize("c", [128, 5])
def test_blur_forward_matches_jax(pad, up, c):
    x = np.random.default_rng(0).normal(size=(2, 11, 9, c)).astype(np.float32)
    want = np.asarray(_jax_fn(pad, up)(jnp.asarray(x)))
    got = _port(torch.from_numpy(x), pad, up).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pad", [(2, 2), (1, 1)])
def test_blur_matches_pallas_kernel(pad):
    from jax.experimental.pallas import tpu as pltpu

    from contrad_tpu.ops.pallas_blur import pallas_blur2d

    x = np.random.default_rng(1).normal(size=(2, 19, 13, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_blur2d(jnp.asarray(x),
                                        jax_make_kernel([1, 3, 3, 1]), pad,
                                        tile_h=8))
    got = _port(torch.from_numpy(x), pad, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pad,up", CASES[:3])
@pytest.mark.parametrize("c", [128, 5])
def test_blur_first_and_second_derivatives_match_jax(pad, up, c):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 10, c)).astype(np.float32)
    f = _jax_fn(pad, up)
    y_shape = f(jnp.asarray(x)).shape
    g = rng.normal(size=y_shape).astype(np.float32)
    h = rng.normal(size=x.shape).astype(np.float32)

    # first derivative: x -> <blur(x), g>
    want_gx = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * g))(jnp.asarray(x)))
    # second: g -> <blur^T g, h>, the path R1's gradient takes
    want_gg = np.asarray(jax.grad(lambda gg: jnp.sum(
        jax.vjp(f, jnp.asarray(x))[1](gg)[0] * h))(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    (gx,) = torch.autograd.grad(_port(xt, pad, up), xt, grad_outputs=gt,
                                create_graph=True)
    (gg,) = torch.autograd.grad(gx, gt, grad_outputs=torch.from_numpy(h))
    np.testing.assert_allclose(gx.detach().numpy(), want_gx, **TOL)
    np.testing.assert_allclose(gg.numpy(), want_gg, **TOL)


@pytest.mark.parametrize("pad,up", CASES)
@pytest.mark.parametrize("symmetric", [True, False])
def test_smoke_derivative_references_are_the_plain_versions_autograd(
        pad, up, symmetric):
    """``chip_smoke.py`` holds the kernel's backward and double backward to
    forward calls of the plain version (reversed taps, complementary pads);
    here those equal autograd through the plain version, and the wrapper's
    ``Function`` on the CPU gives the same. StyleGAN2's taps are symmetric,
    so lopsided ones check the reversal as well."""
    from chip_smoke import case_taps, kernel_derivatives, plain_derivatives

    taps = case_taps(dict(up=up, adjoint=False))
    if not symmetric:
        taps = ((0.1, 0.2, 0.3, 0.4), (0.5, -0.25, 1.0, 2.0))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 11, 9, 3)))
    y_shape = port_blur.blur2d_plain(x, *taps, pad).shape
    g = torch.from_numpy(rng.normal(size=y_shape))
    hh = torch.from_numpy(rng.normal(size=x.shape))
    xx = x.clone().requires_grad_(True)
    gg = g.clone().requires_grad_(True)
    y = port_blur.blur2d_plain(xx, *taps, pad)
    (gx,) = torch.autograd.grad(y, xx, gg, create_graph=True)
    (g2,) = torch.autograd.grad(gx, gg, hh)
    want = (y.detach(), gx.detach(), g2)
    for got in (plain_derivatives(port_blur, x, g, hh, taps, pad),
                kernel_derivatives(port_blur, x, g, hh, taps, pad)):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def test_blur_taps_are_the_jax_separation():
    from contrad_tpu.ops.upfirdn2d import _separate

    col, row = _separate(jax_make_kernel([1, 3, 3, 1]) * 4)
    taps_v, taps_h = blur_taps(make_kernel([1, 3, 3, 1]), 2)
    np.testing.assert_array_equal(np.float32(taps_v), col)
    np.testing.assert_array_equal(np.float32(taps_h), row)


@pytest.mark.parametrize("pad", [(-1, 0), (0, 4), (4, 4)])
def test_blur_rejects_pads_outside_the_taps(pad):
    with pytest.raises(ValueError):
        port_blur.blur2d(torch.zeros(1, 4, 4, 2), (1.0,) * 4, (1.0,) * 4, pad)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = port_blur.blur2d.launches
    x = torch.randn(1, 6, 6, 3)
    y = port_blur.blur2d(x, (0.25, 0.75, 0.75, 0.25), (0.25,) * 4, (1, 2))
    torch.testing.assert_close(
        y, port_blur.blur2d_plain(x, (0.25, 0.75, 0.75, 0.25), (0.25,) * 4,
                                  (1, 2)))
    assert port_blur.blur2d.launches == before



# ------------------------------------------------------------ launch plan
# ``launch_plan`` is the wrapper's choice of path and work split for the CUDA
# kernel; it is plain Python, so it is tested here. ``_emulate_kernel`` runs
# the kernel's schedule (blocks, threads, the ring of input rows, the
# register window of vertical partial sums) in numpy from a plan, in float64:
# it shows that every output element is written exactly once, with the right
# value, for the plans the wrapper makes.

def _main_path_cases():
    from chip_smoke import blur_cases

    return [(c["shape"], c["pad"], c["per_step"]) for c in blur_cases()]


def _emulate_kernel(x, taps_v, taps_h, pad, plan):
    n, h, w, c = x.shape
    k, gb, vec = plan.k, plan.gb, c // plan.groups
    xg = x.reshape(n, h, w, plan.groups, vec)
    y = np.full((n, plan.ho, plan.wo, plan.groups, vec), np.nan)
    t = np.arange(plan.threads)
    for strip in range(plan.strips):
        for seg in range(plan.nseg):
            for cs in range(plan.csplit):
                oh0, ow0, g0 = strip * plan.rows, seg * plan.wseg, cs * gb
                rows_in = min(plan.rows, plan.ho - oh0) + k - 1
                s = np.arange((plan.wseg + k - 1) * gb)  # one ring row
                assert len(s) <= k * plan.threads  # <= k copies a thread
                iw, g = ow0 - plan.pad0 + s // gb, g0 + s % gb
                col_ok = (iw >= 0) & (iw < w) & (g < plan.groups)
                col, gl = t // gb, t % gb
                act = (col < min(plan.wseg, plan.wo - ow0)) & (
                    g0 + gl < plan.groups)
                col, gl = col[act], gl[act]
                acc = np.zeros((k, n, len(col), vec))
                for r in range(rows_in):
                    ih = oh0 + r - plan.pad0
                    ring = np.zeros((n, len(s), vec))
                    if 0 <= ih < h:
                        ring[:, col_ok] = xg[:, ih, iw[col_ok], g[col_ok]]
                    hs = sum(taps_h[a] * ring[:, (col + a) * gb + gl]
                             for a in range(k))
                    for j in range(k):
                        acc[j] += taps_v[k - 1 - j] * hs
                    if r >= k - 1:
                        out = y[:, oh0 + r - k + 1, ow0 + col, g0 + gl]
                        assert np.isnan(out).all()  # written once
                        y[:, oh0 + r - k + 1, ow0 + col, g0 + gl] = acc[0]
                    acc = np.concatenate([acc[1:], np.zeros_like(acc[:1])])
    assert not np.isnan(y).any()  # written everywhere
    return y.reshape(n, plan.ho, plan.wo, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_puts_the_main_path_on_the_vector_path(dtype):
    cases = _main_path_cases()
    # the 32x32 step's 15 forward shapes, the 512x512 step's 35, and
    # their adjoints
    assert len(cases) == 100
    for shape, pad, per_step in cases:
        plan = port_blur.launch_plan(shape, 4, pad, dtype)
        assert plan.vector == 1 and plan.groups * 16 // dtype.itemsize == shape[3]
        assert plan.threads % 32 == 0 and plan.threads <= port_blur._MAX_THREADS
        assert plan.smem <= 48 * 1024
        # no thread slot outside the output but the last warp's rounding
        assert plan.threads - plan.wseg * plan.gb < 32
        assert plan.wseg * (plan.nseg - 1) < plan.wo <= plan.wseg * plan.nseg
        assert plan.rows * (plan.strips - 1) < plan.ho <= plan.rows * plan.strips
        blocks = plan.n * plan.strips * plan.nseg * plan.csplit
        if "stylegan2_32" in per_step:
            # at least two blocks for each of the card's 132 SMs
            assert blocks >= 2 * 132
        else:
            # the 512x512 step's small blurs: two blocks for each SM, short
            # of it by less than one strip's blocks where whole strips do
            # not divide the output so, or one strip per output row where
            # it has too few rows
            base = plan.n * plan.nseg * plan.csplit  # blocks per strip
            assert blocks > 2 * 132 - base or plan.strips == plan.ho


@pytest.mark.parametrize("shape,dtype,aligned,vector", [
    ((2, 8, 8, 5), torch.float32, True, 0),
    ((2, 8, 8, 37), torch.bfloat16, True, 0),
    ((2, 8, 8, 4), torch.float32, True, 1),
    ((2, 8, 8, 12), torch.bfloat16, True, 0),
    ((2, 8, 8, 128), torch.float32, False, 0),
    ((2, 8, 8, 128), torch.bfloat16, False, 0),
])
def test_launch_plan_takes_the_scalar_path_where_packs_do_not_fit(
        shape, dtype, aligned, vector):
    plan = port_blur.launch_plan(shape, 4, (1, 1), dtype, aligned=aligned)
    assert plan.vector == vector
    assert plan.groups == shape[3] // (16 // dtype.itemsize if vector else 1)
    assert plan.csplit * plan.gb >= plan.groups > (plan.csplit - 1) * plan.gb


def test_launch_plan_refuses_more_images_than_the_grid_holds():
    with pytest.raises(ValueError):
        port_blur.launch_plan((65536, 4, 4, 8), 4, (1, 1), torch.float32)


@pytest.mark.parametrize("shape,pad,k,dtype", [
    ((2, 9, 9, 512), (1, 1), 4, torch.float32),  # G's 8->16 blur, 4 splits
    ((2, 30, 30, 128), (2, 2), 4, torch.float32),  # a short last strip
    ((2, 31, 31, 128), (2, 2), 4, torch.bfloat16),  # an adjoint shape
    ((2, 40, 300, 32), (0, 3), 4, torch.float32),  # several width segments
    ((1, 12, 13, 16), (3, 0), 4, torch.bfloat16),
    ((3, 17, 9, 37), (2, 1), 4, torch.float32),  # scalar, two channel splits
    ((3, 17, 9, 5), (1, 2), 4, torch.bfloat16),
    ((2, 10, 7, 16), (1, 1), 3, torch.float32),
    ((2, 10, 7, 16), (1, 0), 2, torch.float32),
    ((2, 10, 7, 16), (0, 0), 1, torch.float32),
])
def test_kernel_schedule_covers_the_output_once_and_matches_plain(
        shape, pad, k, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape)
    taps_v = tuple(rng.uniform(0.1, 1.0, size=k))
    taps_h = tuple(rng.uniform(0.1, 1.0, size=k))
    plan = port_blur.launch_plan(shape, k, pad, dtype)
    got = _emulate_kernel(x, taps_v, taps_h, pad, plan)
    want = port_blur.blur2d_plain(torch.from_numpy(x), taps_v, taps_h, pad)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)


def test_evaluation_path_cases_are_what_the_models_launch(monkeypatch):
    """``chip_smoke.eval_blur_cases`` against the blur calls that the port's
    32x32 StyleGAN2 G and D (full width, on the CPU, small batches) make
    on each evaluation path: a probe step's features and a shorter test
    batch, a Langevin step (whose forward blurs all see inputs that need a
    gradient, so each has an adjoint), a chain's final sample, a batch of
    samples, a chunk of the in-loop FID sampler and a frame of the progress
    GIF; each forward case once per call, and the adjoint rows the
    Langevin step's forward calls give by the rule of ``blur_cases``. Every
    case takes the vector path in float32 and bfloat16."""
    from collections import Counter

    import contrad_tpu_torch.models.stylegan2.layers as layers
    from chip_smoke import eval_blur_cases
    from contrad_tpu_torch.evaluate.sharded import make_feature_sampler
    from contrad_tpu_torch.models import generate, get_architecture
    from contrad_tpu_torch.test_gan_sample_cddls import langevin_step
    from contrad_tpu_torch.test_lineval import features

    calls, real = [], layers.blur2d

    def spy(x, taps_v, taps_h, pad):
        calls.append((tuple(x.shape), tuple(pad), x.requires_grad))
        return real(x, taps_v, taps_h, pad)

    monkeypatch.setattr(layers, "blur2d", spy)
    G, D = get_architecture("stylegan2", (32, 32, 3), device="cpu", seed=0)
    G.requires_grad_(False)
    D.requires_grad_(False)
    rng = torch.Generator().manual_seed(0)
    w, b = torch.randn(D.d_penul, 10) * 0.01, torch.zeros(10)
    recorded = {}

    def record(path, fn):
        calls.clear()
        fn()
        recorded[path] = list(calls)

    record("lineval_32", lambda: features(D, torch.rand(4, 32, 32, 3)))
    record("lineval_32_tail", lambda: features(D, torch.rand(2, 32, 32, 3)))
    z = G.sample_latent(4, rng)
    record("cddls_32", lambda: langevin_step(
        G, D, w, b, z, torch.randn(4, 32, 32, 3), 3, 0.01, 0.1, 1.0,
        G.draw_noise(4, rng, z.device), torch.randn_like(z),
        torch.randn(4, 32, 32, 3)))
    with torch.no_grad():
        record("cddls_32_final", lambda: generate(G, z, noise_rng=rng))
        record("sample_32", lambda: generate(G, z[:3], noise_rng=rng))
        record("gif_32", lambda: generate(G, z[:2], noise_rng=rng))
    trainer = type("T", (), dict(g_ema=G, device=torch.device("cpu")))
    record("fid_32", lambda: make_feature_sampler(
        trainer, "moments", batch_per_call=5, use_ema=True)(5, 0))

    cases = eval_blur_cases(probe_batch=4, probe_tail=2, cddls_batch=4,
                            sample_batch=3, fid_batch=5, gif_batch=2)
    for path, got in recorded.items():
        want = Counter()
        for c in cases:
            if not c["adjoint"] and path in c["per_step"]:
                want[(tuple(c["shape"]), tuple(c["pad"]))] += \
                    c["per_step"][path]
        assert Counter((s, p) for s, p, _ in got) == want, path
        needs_grad = [(s, p) for s, p, g in got if g]
        assert len(needs_grad) == (len(got) if path == "cddls_32" else 0)
        adjoint = Counter(
            (tuple(c["shape"]), tuple(c["pad"])) for c in cases
            if c["adjoint"] and path in c["per_step"])
        assert adjoint == Counter(
            ((n, h + sum(p) - 3, w_ + sum(p) - 3, ch), (3 - p[0], 3 - p[1]))
            for (n, h, w_, ch), p in needs_grad), path
    for c in eval_blur_cases():
        for dtype in (torch.float32, torch.bfloat16):
            plan = port_blur.launch_plan(c["shape"], 4, c["pad"], dtype)
            assert plan.vector == 1, c
