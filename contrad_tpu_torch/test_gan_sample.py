"""Random sampling CLI of the port (the counterpart of the repo root's
``test_gan_sample.py``): load a trained G from a run's logdir and write
``n_samples`` PNGs into ``<logdir>/samples_<rand>_n<N>/``.

    python -m contrad_tpu_torch.test_gan_sample <logdir> sndcgan \\
        --n_samples 10000 [--use_ema] [--ckpt latest]

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Random sampling from a trained G")
    p.add_argument("logdir", type=str, help="Run logdir (ckpt/ and config)")
    p.add_argument("architecture", type=str)
    p.add_argument("--n_samples", default=10000, type=int)
    p.add_argument("--batch_size", default=500, type=int)
    p.add_argument("--ckpt", default="latest", type=str,
                   help="latest | step_N")
    p.add_argument("--use_ema", action="store_true",
                   help="sample from the EMA generator (StyleGAN2 runs)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write the samples; returns their directory."""
    from contrad_tpu_torch.evaluate.visual import to_uint8, write_png
    from contrad_tpu_torch.models import generate
    from contrad_tpu_torch.utils.run_loading import load_run

    P = parse_args(argv)
    _, generator, _, g_ema, _ = load_run(P.logdir, P.architecture,
                                         ckpt=P.ckpt, device=P.device)
    if P.use_ema:
        if g_ema is None:
            raise ValueError(f"{P.logdir} keeps no EMA generator")
        generator = g_ema
    device = next(generator.parameters()).device

    subdir = os.path.join(P.logdir, f"samples_{np.random.randint(10000)}"
                                    f"_n{P.n_samples}")
    os.makedirs(subdir, exist_ok=True)
    print(f"Sampling in {subdir}")

    rng = torch.Generator(device=device).manual_seed(P.seed)
    index = 0
    with torch.no_grad():
        for _ in range(math.ceil(P.n_samples / P.batch_size)):
            z = generator.sample_latent(P.batch_size, rng)
            images = to_uint8(generate(generator, z, noise_rng=rng))
            for image in images[: P.n_samples - index]:
                write_png(os.path.join(subdir, f"{index}.png"), image)
                index += 1
    print(f"Wrote {index} samples.")
    return subdir


if __name__ == "__main__":
    main()
