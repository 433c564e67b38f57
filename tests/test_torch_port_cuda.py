"""The port on the card: the CUDA blur kernel against its plain version on
every code path it has (16-byte packs in float32 and bfloat16; one channel a
pack where C * itemsize % 16 != 0 or the data is not 16-byte aligned; strips
that do not divide the height; rows wider than one block; asymmetric pads;
1 to 4 taps; the 512x512 recipe's largest tensors), under a CUDA graph, and
the StyleGAN2 G and D going through it. Every test here needs a CUDA card
and skips without one (the kernel has no CPU mode). The file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: float32 with TF32 off, 8 taps summed in another order,
rtol 1e-5 / atol 1e-5; bfloat16 outputs rounded once from float32 in both
versions, one bfloat16 ulp apart at most, rtol 1e-2 / atol 1e-2; the models
on the card vs on the CPU, float32 convs in other orders, rtol 1e-4 /
atol 1e-4."""

import copy

import pytest
import torch

from contrad_tpu_torch.ops import blur
from contrad_tpu_torch.ops.upfirdn2d import blur_taps, make_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blur kernel has no CPU mode")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,pad,up", [
    ((3, 17, 9, 37), (2, 1), 1),  # odd C, uneven pads
    ((2, 9, 9, 512), (1, 1), 2),  # G's first post-upsample blur
    ((4, 32, 32, 128), (0, 3), 1),  # the adjoint pads of a (3, 0) blur
])
def test_kernel_matches_plain_forward_backward_and_double(cuda, dtype, tol,
                                                          shape, pad, up):
    taps = blur_taps(make_kernel([1, 3, 3, 1]), up)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)

    def run(fn):
        xx = x.clone().requires_grad_(True)
        y = fn(xx, *taps, pad)
        g = torch.ones_like(y).requires_grad_(True)
        (gx,) = torch.autograd.grad(y, xx, g, create_graph=True)
        (gg,) = torch.autograd.grad(gx, g, torch.ones_like(xx))
        return y.detach(), gx.detach(), gg

    before = blur.blur2d.launches
    got = run(blur.blur2d)
    torch.cuda.synchronize()
    assert blur.blur2d.launches == before + 3  # forward, adjoint, forward
    want = run(blur.blur2d_plain)
    assert blur.blur2d.launches == before + 3
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,pad", [
    ((48, 512, 512, 32), (2, 2)),  # the 512x512 D phase's largest blur
    ((48, 513, 513, 32), (1, 1)),  # its adjoint
])
def test_kernel_at_the_largest_tensors_of_the_512_recipe(cuda, shape, pad):
    """The largest tensors any path of the port gives the kernel: 1.6 GB
    in and 1.6 GB out in float32, 48 images on the grid's y."""
    taps = blur_taps(make_kernel([1, 3, 3, 1]), 1)
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    got = blur.blur2d(x, *taps, pad)
    want = blur.blur2d_plain(x, *taps, pad)
    assert got.shape == want.shape == (shape[0], shape[1] + sum(pad) - 3,
                                       shape[2] + sum(pad) - 3, shape[3])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the last image's last rows, the far end of both tensors
    torch.testing.assert_close(got[-1, -4:], want[-1, -4:], rtol=1e-5,
                               atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(cuda):
    taps = (0.25, 0.25, 0.25, 0.25)
    with pytest.raises(TypeError):
        blur.blur2d(torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.float16),
                    taps, taps, (1, 1))
    with pytest.raises(ValueError):
        blur.blur2d(torch.zeros(1, 4, 4, 2, device=cuda), (0.2,) * 5,
                    (0.2,) * 5, (1, 1))
    with pytest.raises(ValueError):
        blur.blur2d(torch.zeros(65536, 1, 1, 1, device=cuda), taps, taps,
                    (2, 1))
    before = blur.blur2d.launches
    empty = blur.blur2d(torch.zeros(0, 4, 4, 2, device=cuda), taps, taps,
                        (1, 1))
    assert empty.shape == (0, 3, 3, 2) and blur.blur2d.launches == before


def test_models_go_through_the_kernel_and_match_the_cpu(cuda):
    from contrad_tpu_torch.models import get_architecture

    G, D = get_architecture("stylegan2_tiny", (16, 16, 3), device=cuda,
                            seed=0)
    Gc, Dc = copy.deepcopy(G).cpu(), copy.deepcopy(D).cpu()
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(4, G.style_dim, generator=gen)
    noise = G.draw_noise(4, gen, torch.device("cpu"))
    mixing = G.draw_mixing(4, 0.9, gen, torch.device("cpu"))

    before = blur.blur2d.launches
    with torch.no_grad():
        img = G(z.to(cuda), [a.to(cuda) for a in noise],
                tuple(m.to(cuda) for m in mixing))
        assert blur.blur2d.launches == before + 2  # the 8x8 and 16x16 levels
        d, aux = D(img)
        assert blur.blur2d.launches == before + 2 + 4  # 2 ResBlocks x 2
        img_c = Gc(z, noise, mixing)
        d_c, aux_c = Dc(img_c)
    assert blur.blur2d.launches == before + 6
    torch.testing.assert_close(img.cpu(), img_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(d.cpu(), d_c, rtol=1e-4, atol=1e-4)
    for k in aux:
        torch.testing.assert_close(aux[k].cpu(), aux_c[k], rtol=1e-4,
                                   atol=1e-4)


def _check_against_plain(x, taps, pad, tol, path):
    """Forward, backward and double backward of the kernel against the plain
    version, random cotangents; each of the three launches takes ``path``."""
    gen = torch.Generator(device=x.device).manual_seed(1)
    y_shape = blur.blur2d_plain(x, *taps, pad).shape
    g = torch.randn(y_shape, generator=gen, device=x.device).to(x.dtype)
    hh = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)

    def run(fn):
        xx = x.detach().clone().requires_grad_(True)
        gg = g.clone().requires_grad_(True)
        y = fn(xx, *taps, pad)
        (gx,) = torch.autograd.grad(y, xx, gg, create_graph=True)
        (g2,) = torch.autograd.grad(gx, gg, hh)
        return y.detach(), gx.detach(), g2

    launches, scalar = blur.blur2d.launches, blur.blur2d.scalar_launches
    got = run(blur.blur2d)
    torch.cuda.synchronize()
    assert blur.blur2d.launches == launches + 3
    assert blur.blur2d.scalar_launches == scalar + 3 * (path == "scalar")
    want = run(blur.blur2d_plain)
    for a, b in zip(got, want):
        assert a.dtype == x.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,pad,k,path", [
    ((4, 32, 32, 128), (2, 2), 4, "vector"),  # D's 3x3 downsample blur
    ((40, 30, 30, 128), (2, 2), 4, "vector"),  # 31 rows: strips of 8, then 7
    ((2, 300, 300, 32), (1, 1), 4, "vector"),  # wider than one block
    ((3, 20, 24, 64), (0, 3), 4, "vector"),  # asymmetric pads
    ((3, 24, 20, 64), (3, 0), 4, "vector"),
    ((2, 9, 11, 256), (1, 1), 3, "vector"),  # 3, 2 and 1 taps
    ((2, 9, 11, 256), (0, 1), 2, "vector"),
    ((2, 9, 11, 256), (0, 0), 1, "vector"),
    ((3, 17, 9, 5), (2, 1), 4, "scalar"),  # C * itemsize % 16 != 0
    ((3, 17, 9, 37), (1, 2), 4, "scalar"),
])
def test_kernel_paths_match_plain(cuda, dtype, tol, shape, pad, k, path):
    taps = (tuple(float(t) for t in torch.linspace(0.1, 0.7, k)),
            tuple(float(t) for t in torch.linspace(0.6, 0.2, k)))
    plan = blur.launch_plan(shape, k, pad, dtype)
    assert plan.vector == (path == "vector")
    if shape[1] == 30:  # the strips do not divide the height
        assert plan.ho % plan.rows != 0 and plan.strips > 1
    if shape[2] == 300:
        assert plan.nseg > 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    _check_against_plain(x, taps, pad, tol, path)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_misaligned_data_takes_the_scalar_path(cuda, dtype, tol):
    shape = (2, 16, 16, 128)
    base = torch.randn(1 + torch.Size(shape).numel(), device=cuda).to(dtype)
    x = base[1:].view(shape)  # contiguous, storage offset of one element
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    taps = blur_taps(make_kernel([1, 3, 3, 1]), 1)
    scalar = blur.blur2d.scalar_launches
    y = blur.blur2d(x, *taps, (2, 2))
    assert blur.blur2d.scalar_launches == scalar + 1
    torch.testing.assert_close(y.float(), blur.blur2d_plain(
        x, *taps, (2, 2)).float(), rtol=tol, atol=tol)


def test_kernel_replays_under_a_cuda_graph(cuda):
    taps = blur_taps(make_kernel([1, 3, 3, 1]), 1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((8, 32, 32, 128), generator=gen, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs ask
        blur.blur2d(x, *taps, (2, 2))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = blur.blur2d(x, *taps, (2, 2))
    for _ in range(2):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, blur.blur2d(x, *taps, (2, 2)))


# ------------------------------------------------------------ CUDA graphs

def _tiny_trainer(cli, argv, dataset="synthetic_16_64"):
    """A trainer and loader of the port's CLI ``cli`` on the card, at a
    tiny width: 16x16 synthetic data, batch 4."""
    P = cli.parse_args(argv + ["--override", f"options.dataset={dataset}",
                               "options.batch_size=4"])
    _, loader, trainer = cli.build(P)
    return loader, trainer


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().clone()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return {prefix: torch.tensor(tree)}
    return {}


def _block_run(trainer, loader, snapshot, graphs, idx, ema, r1, labels=None,
               k=4):
    """From ``snapshot``, the steps of ``idx`` in blocks of ``k`` through a
    ``BlockRunner`` (CUDA graphs or eager steps); every tensor of the
    trainer's state, the device counts, the last metrics and the runner."""
    from contrad_tpu_torch.training.graph import BlockRunner

    trainer.load_state_dict(snapshot)
    runner = BlockRunner(trainer, loader, graphs=graphs)
    for b in range(0, len(idx), k):
        metrics = runner.run(idx[b:b + k], None if labels is None
                             else labels[b:b + k], ema[b:b + k], r1[b:b + k])
    torch.cuda.synchronize()
    state = _flat(trainer.state_dict())
    state.update({f"metric/{k}": v.clone() for k, v in metrics.items()})
    state["g_count_t"] = trainer.g_tx.count_t.clone()
    state["d_count_t"] = trainer.d_tx.count_t.clone()
    return state, runner


def _graph_matches_eager(trainer, loader, idx, ema, r1, labels=None):
    """The graph run against the eager run, with a second eager run as the
    yardstick of the kernels' own nondeterminism: bitwise where the eager
    runs agree bitwise, else within twice their distance and 1e-4 + 1e-4 *
    max. Returns the graph runner and the launches each run made."""
    from contrad_tpu_torch.training.graph import _clone

    snapshot = _clone(trainer.state_dict())
    launches = []
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True, False):
            before = blur.blur2d.launches
            runs.append(_block_run(trainer, loader, snapshot, graphs, idx,
                                   ema, r1, labels))
            launches.append(blur.blur2d.launches - before)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print("eager runs differ in", sum(not torch.equal(a, runs[2][0][n])
                                      for n, a in runs[0][0].items()),
          "of", len(runs[0][0]), "tensors")
    (eager, _), (graph, runner), (again, _) = runs
    assert eager.keys() == graph.keys()
    for name, a in eager.items():
        b, g = again[name], graph[name]
        assert g.dtype == a.dtype and g.shape == a.shape, name
        if torch.equal(a, b):
            assert torch.equal(g, a), name
        else:
            spread = (b.double() - a.double()).abs().max()
            err = (g.double() - a.double()).abs().max()
            assert err <= 2 * spread, (name, float(err), float(spread))
            assert err <= 1e-4 + 1e-4 * a.double().abs().max(), name
    assert torch.equal(graph["/rng/device"], eager["/rng/device"])
    return runner, launches


def test_stylegan2_block_replays_bitwise_as_eager_steps(cuda):
    """Two blocks of four steps of a tiny StyleGAN2 + ContraD trainer (R1
    every second step, the EMA gate opening inside the first block) as CUDA
    graph replays against the same steps eagerly; the blur's launches
    counted at each replay."""
    import numpy as np

    from contrad_tpu_torch import train_stylegan2
    from contrad_tpu_torch.training.graph import WARMUP_STEPS

    loader, trainer = _tiny_trainer(train_stylegan2, [
        "configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny", "--mode",
        "contrad", "--aug", "simclr", "--lbd_r1", "0.1", "--d_reg_every", "2",
        "--use_warmup"])
    idx = [loader.next_indices()[0] for _ in range(8)]
    steps = np.arange(1, 9)
    r1 = steps % 2 == 0
    ema = np.where(steps > 2, 0.99, 0.0)
    per_kind = {}
    for kind, flag in (("plain", False), ("r1", True)):
        before = blur.blur2d.launches
        trainer.train_step(loader.materialize(idx[0]), do_r1=flag)
        per_kind[kind] = blur.blur2d.launches - before
    assert per_kind["plain"] > 0 and per_kind["r1"] > per_kind["plain"]
    runner, launches = _graph_matches_eager(trainer, loader, idx, ema, r1)
    stats = runner.stats
    assert stats["replays"] == {"plain": 4, "r1": 4}
    assert stats["captured_launches"] == per_kind
    assert stats["replay_launches"] == 4 * (per_kind["plain"]
                                            + per_kind["r1"])
    warm = sum(WARMUP_STEPS * per_kind[k] for k in stats["capture_seconds"])
    assert launches[1] == stats["replay_launches"] + warm
    assert launches[0] == launches[2] == stats["replay_launches"]
    assert trainer.g_tx.count == trainer.d_tx.count == 2 + 8  # 2 above


def test_conditional_flagship_block_replays_as_eager_steps(cuda):
    """The conditional SNDCGAN flagship's step, its labels in the graph's
    static row, as graph replays against eager steps; no blur launch."""
    import numpy as np

    from contrad_tpu_torch import train_gan

    loader, trainer = _tiny_trainer(train_gan, [
        "configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
        "--aug", "simclr", "--use_warmup", "--conditional"],
        dataset="synthetic_16_256")
    pairs = [loader.next_indices() for _ in range(8)]
    idx, labels = [p[0] for p in pairs], [p[1] for p in pairs]
    runner, launches = _graph_matches_eager(
        trainer, loader, idx, np.zeros(8), np.zeros(8, bool), labels)
    assert runner.stats["replays"] == {"plain": 8}
    assert launches == [0, 0, 0]


def test_a_capture_that_fails_raises(cuda):
    """A step that reads a device value on the host cannot be captured: the
    runner raises and runs nothing eagerly in its place."""
    from contrad_tpu_torch import train_stylegan2
    from contrad_tpu_torch.training.graph import BlockRunner

    loader, trainer = _tiny_trainer(train_stylegan2, [
        "configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
        "--lbd_r1", "0.1"])
    step = trainer.train_step

    def reads_the_loss(*args, **kwargs):
        metrics = step(*args, **kwargs)
        float(metrics["D_loss"])
        return metrics

    trainer.train_step = reads_the_loss
    idx = [loader.next_indices()[0] for _ in range(2)]
    with pytest.raises(RuntimeError):
        BlockRunner(trainer, loader).run(idx)


@pytest.mark.parametrize("which", ["stylegan2_tiny", "conditional_flagship"])
def test_an_nccl_world_of_one_replays_bitwise_as_the_worldless_step(
        cuda, monkeypatch, which):
    """An NCCL world of one (``parallel.init_distributed``): two blocks of
    four steps as CUDA graph replays, the step's gathers and gradient
    all-reduce captured inside the graphs, bitwise equal (cuDNN
    deterministic) to the same steps eagerly without a world; the
    collectives counted at each replay."""
    import numpy as np

    from contrad_tpu_torch import train_gan, train_stylegan2
    from contrad_tpu_torch.hostenv import RENDEZVOUS_VARS, free_port, rank_env
    from contrad_tpu_torch.parallel import collectives, mesh
    from contrad_tpu_torch.training.graph import _clone

    if which == "stylegan2_tiny":
        loader, trainer = _tiny_trainer(train_stylegan2, [
            "configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
            "--mode", "contrad", "--aug", "simclr", "--lbd_r1", "0.1",
            "--d_reg_every", "2", "--use_warmup"])
    else:
        loader, trainer = _tiny_trainer(train_gan, [
            "configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode",
            "contrad", "--aug", "simclr", "--use_warmup", "--conditional"],
            dataset="synthetic_16_256")
    pairs = [loader.next_indices() for _ in range(8)]
    idx = [p[0] for p in pairs]
    labels = [p[1] for p in pairs] if trainer.conditional else None
    steps = np.arange(1, 9)
    r1 = (steps % 2 == 0) & (which == "stylegan2_tiny")
    ema = np.where(steps > 2, 0.99, 0.0)
    snapshot = _clone(trainer.state_dict())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for k in RENDEZVOUS_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in rank_env({}, free_port(), 0, 1).items():
        monkeypatch.setenv(k, v)
    try:
        solo, _ = _block_run(trainer, loader, snapshot, False, idx, ema, r1,
                             labels)
        mesh.init_distributed("cuda")
        assert mesh.backend() == "nccl" and mesh.data_shard() == (0, 1)
        before = dict(collectives.counts)
        world, runner = _block_run(trainer, loader, snapshot, True, idx, ema,
                                   r1, labels)
    finally:
        mesh.shutdown()
        torch.backends.cudnn.deterministic = deterministic
    assert solo.keys() == world.keys()
    for name, a in solo.items():
        assert torch.equal(a, world[name]), name
    captured = runner.stats["captured_collectives"]
    assert captured and all(c["calls"] > 0 for c in captured.values())
    replayed = sum(captured[k]["calls"] * n
                   for k, n in runner.stats["replays"].items())
    assert collectives.counts["calls"] - before["calls"] >= replayed


def test_prefetch_copies_pinned_batches_to_the_card(cuda):
    """The host-fed stream on the card (``data/core.py::PrefetchIterator``):
    its batches, copied from pinned buffers on a side stream, are the host
    stream's, bitwise, once the consuming stream has waited for them; the
    copies are timed as their buffers come round; a resumed stream goes on
    at the consumer's position."""
    import numpy as np

    from contrad_tpu_torch.data import (
        ArrayDataset, BatchIterator, PrefetchIterator)

    rng = np.random.default_rng(0)
    data = ArrayDataset(rng.integers(0, 256, size=(40, 64, 64, 3),
                                     dtype=np.uint8),
                        rng.integers(0, 10, size=40), n_classes=10)
    it = PrefetchIterator(BatchIterator(data, 8, seed=1), device=cuda)
    ref = BatchIterator(data, 8, seed=1)
    for _ in range(12):  # 5 batches an epoch: across two boundaries
        images, labels = next(it)
        assert images.device.type == "cuda" and labels.dtype == torch.int64
        want_images, want_labels = next(ref)
        assert torch.equal(images.cpu(), torch.from_numpy(want_images))
        assert torch.equal(labels.cpu(), torch.from_numpy(want_labels))
    assert it.stats["copies_timed"] >= 12 - 2 * (it.depth + 1)
    assert it.stats["copy_ms"] > 0
    state = it.state_dict()
    it.close()
    resumed = PrefetchIterator(BatchIterator(data, 8, seed=1), device=cuda)
    resumed.load_state_dict(state)
    assert torch.equal(next(resumed)[0].cpu(),
                       torch.from_numpy(next(ref)[0]))
    resumed.close()
