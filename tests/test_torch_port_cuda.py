"""The port on the card: the CUDA blur kernel against its plain version, and
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
