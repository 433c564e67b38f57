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
