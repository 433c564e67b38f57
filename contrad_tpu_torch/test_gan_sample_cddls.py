"""Class-conditional Discriminator-Driven Langevin Sampling, the port's CLI
(the counterpart of the repo root's ``test_gan_sample_cddls.py``).

    python -m contrad_tpu_torch.test_gan_sample_cddls <logdir> \\
        <logdir>/lin_eval_<tag>.npz sndcgan --ckpt latest

Energy ``E(z, z2) = sum(-(D(G(z) + eps z2) + lbd * logit_y) + 0.5 |z2|^2)``
with ``logit_y`` the linear probe's (``lin_eval_*.npz`` of
``test_lineval``) on D's penultimate features; ``n_steps`` Langevin updates
of ``(z, z2)`` with step ``eps`` and noise ``sigma_n * sqrt(eps)``, ``z``
clamped to [-1, 1] after each; the sample is ``clamp(G(z) + eps z2, 0, 1)``
(``test_gan_sample_cddls.py:87-138``). G and D run in eval mode; a
StyleGAN2 G draws fresh noise maps at every step. The chain is one loop on
the device with ``torch.autograd.grad`` on ``(z, z2)`` and no host
synchronisation inside it. Samples go to
``<logdir>/samples_cDDLS_<rand>/<class>/<index>.png``,
``n_samples // n_classes`` per class. ``--ckpt`` defaults to ``latest``:
the port writes no ``best`` (chosen by FID, not ported). It runs on the
card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="cDDLS sampling")
    p.add_argument("logdir", type=str, help="Run logdir with G/D checkpoints")
    p.add_argument("linear_path", type=str,
                   help="the linear-eval probe (lin_eval_*.npz)")
    p.add_argument("architecture", type=str)
    p.add_argument("--lbd", default=1.0, type=float)
    p.add_argument("--n_steps", default=1000, type=int)
    p.add_argument("--eps", default=0.01, type=float)
    p.add_argument("--sigma_n", default=0.1, type=float)
    p.add_argument("--n_samples", default=10000, type=int)
    p.add_argument("--n_classes", default=10, type=int)
    p.add_argument("--batch_size", default=500, type=int)
    p.add_argument("--ckpt", default="latest", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def energy(G, D, w, b, z, z2, y: int, eps: float, lbd: float,
           noise: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The chain's energy, summed over the batch; ``noise`` is a StyleGAN2
    G's noise maps (None for SNDCGAN)."""
    from contrad_tpu_torch.models import generate

    images = generate(G, z, noise=noise) + eps * z2
    d_out, aux = D(images, train=False, persist=False)
    l_out = (aux["penultimate"] @ w + b)[:, y: y + 1]
    reg = 0.5 * torch.sum(z2.reshape(z2.shape[0], -1) ** 2, dim=1,
                          keepdim=True)
    return torch.sum(-(d_out + lbd * l_out) + reg)


def langevin_step(G, D, w, b, z, z2, y: int, eps: float, sigma_n: float,
                  lbd: float, noise, n_z, n_z2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update of ``(z, z2)`` with the Gaussian draws ``n_z``, ``n_z2``
    (and G's ``noise`` maps)."""
    z = z.detach().requires_grad_(True)
    z2 = z2.detach().requires_grad_(True)
    g_z, g_z2 = torch.autograd.grad(
        energy(G, D, w, b, z, z2, y, eps, lbd, noise), (z, z2))
    scale = sigma_n * math.sqrt(eps)
    with torch.no_grad():
        z = torch.clamp(z - 0.5 * eps * g_z + scale * n_z, -1.0, 1.0)
        z2 = z2 - 0.5 * eps * g_z2 + scale * n_z2
    return z, z2


def draw_noise(G, n: int, rng: torch.Generator, device):
    """A StyleGAN2 G's noise maps for one forward; None for SNDCGAN."""
    return (G.draw_noise(n, rng, device) if hasattr(G, "draw_noise")
            else None)


def sample_class(G, D, w, b, z, y: int, P, rng: torch.Generator,
                 image_size: Tuple[int, int, int]) -> torch.Tensor:
    """``P.n_steps`` Langevin updates from the latents ``z``, then the
    class-``y`` samples in [0, 1]."""
    n, device = z.shape[0], z.device
    z2 = torch.randn((n,) + tuple(image_size), generator=rng, device=device)
    for _ in range(P.n_steps):
        noise = draw_noise(G, n, rng, device)
        n_z = torch.randn(z.shape, generator=rng, device=device)
        n_z2 = torch.randn(z2.shape, generator=rng, device=device)
        z, z2 = langevin_step(G, D, w, b, z, z2, y, P.eps, P.sigma_n, P.lbd,
                              noise, n_z, n_z2)
    with torch.no_grad():
        from contrad_tpu_torch.models import generate

        return torch.clamp(generate(G, z, noise_rng=rng) + P.eps * z2,
                           0.0, 1.0)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Write the samples; returns their directory, the samples written and
    the seconds the chains took (PNG writes excluded)."""
    from contrad_tpu_torch.evaluate.visual import to_uint8, write_png
    from contrad_tpu_torch.utils.run_loading import load_run

    P = parse_args(argv)
    _, G, D, _, image_size = load_run(P.logdir, P.architecture, ckpt=P.ckpt,
                                      device=P.device)
    device = next(G.parameters()).device
    probe = np.load(P.linear_path)
    w = torch.from_numpy(probe["w"]).float().to(device)
    b = torch.from_numpy(probe["b"]).float().to(device)

    subdir = os.path.join(P.logdir, f"samples_cDDLS_{np.random.randint(10000)}")
    os.makedirs(subdir, exist_ok=True)
    print(f"Sampling in {subdir}")

    rng = torch.Generator(device=device).manual_seed(P.seed)
    class_samples = P.n_samples // P.n_classes
    n_batches = math.ceil(class_samples / P.batch_size)
    chain_s, written = 0.0, 0
    for y in range(P.n_classes):
        class_dir = os.path.join(subdir, str(y))
        os.makedirs(class_dir, exist_ok=True)
        for i in range(n_batches):
            t0 = time.perf_counter()
            z = G.sample_latent(P.batch_size, rng)
            samples = to_uint8(sample_class(G, D, w, b, z, y, P, rng,
                                             image_size))
            chain_s += time.perf_counter() - t0
            offset = y * class_samples + i * P.batch_size
            for j, image in enumerate(samples):
                index = offset + j
                if index >= (y + 1) * class_samples or index >= P.n_samples:
                    break
                write_png(os.path.join(class_dir, f"{index}.png"), image)
                written += 1
    n_chains = P.n_classes * n_batches
    print(f"Done: {written} samples; {n_chains} chains of {P.n_steps} "
          f"steps at batch {P.batch_size} in {chain_s:.2f} s")
    return dict(subdir=subdir, samples=written, chain_seconds=chain_s,
                chains=n_chains)


if __name__ == "__main__":
    main()
