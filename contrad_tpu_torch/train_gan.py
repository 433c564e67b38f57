"""GAN training CLI of the port (the counterpart of the repo root's
``train_gan.py``), the SNDCGAN + ContraD flagship:

    python -m contrad_tpu_torch.train_gan \\
        configs/gan/cifar10/c10_b512.toml sndcgan \\
        --mode contrad --aug simclr --use_warmup

It reads the same TOML configs and prints the same scalar names
(``D_loss``, ``D_penalty``, ``D_real``, ``D_gen``, ``G_loss``). It runs on
the card; ``--device cpu`` runs it on the CPU. FID, the progress GIF,
checkpoints, ``--conditional``, ``--dtype bf16`` and multi-step dispatch are
not ported yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GAN training on PyTorch")
    p.add_argument("config", type=str)
    p.add_argument("architecture", type=str, help="sndcgan")
    p.add_argument("--mode", default="std", type=str,
                   help="std | aug | aug_both | simclr_only | contrad")
    p.add_argument("--penalty", default="none", type=str,
                   help="none | gp | cr | bcr")
    p.add_argument("--aug", default="none", type=str)
    p.add_argument("--use_warmup", action="store_true")
    p.add_argument("--temp", default=0.1, type=float)
    p.add_argument("--lbd_a", default=1.0, type=float)
    p.add_argument("--print_every", default=50, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def build(P: argparse.Namespace):
    """Config, data stream and trainer for the parsed arguments."""
    from contrad_tpu_torch import resolve_device
    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.config import (
        default_config_files, finalize_options, load_config)
    from contrad_tpu_torch.data import DeviceBatchIterator, get_dataset
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import GANTrainer, ScheduledAdam

    if P.architecture not in ("sndcgan", "snresnet18"):
        raise NotImplementedError(
            f"train_gan runs sndcgan and snresnet18; {P.architecture!r} is "
            f"not ported to it yet")
    device = resolve_device(P.device)
    cfg = finalize_options(load_config(default_config_files(P.config),
                                       P.override))
    opt = cfg.options
    train_set, _, image_size = get_dataset(opt.dataset)
    generator, discriminator = get_architecture(P.architecture, image_size,
                                                device=device, seed=P.seed)

    def adam(module, lr):
        return ScheduledAdam(module.parameters(), lr, tuple(opt.beta),
                             warmup=opt.warmup, use_warmup=P.use_warmup)

    trainer = GANTrainer(
        generator, discriminator, mode=P.mode,
        augment=get_augment(P.aug, cfg.get("augment")),
        g_optimizer=adam(generator, opt.lr),
        d_optimizer=adam(discriminator, opt.lr_d),
        loss_type=opt.loss, penalty=P.penalty, temp=P.temp, lbd_a=P.lbd_a,
        lbd=opt.lbd, lbd2=opt.lbd2, n_critic=opt.n_critic,
        real_augment=(get_augment("hflip") if train_set.train_aug == "hflip"
                      else None),
        seed=P.seed)
    loader = DeviceBatchIterator(train_set, opt.batch_size * opt.n_critic,
                                 seed=P.seed, device=device)
    return cfg, loader, trainer


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train for ``options.max_steps`` steps; returns one record per printed
    step: its metrics and the wall seconds per step since the last print."""
    P = parse_args(argv)
    cfg, loader, trainer = build(P)
    opt = cfg.options
    n_g = sum(p.numel() for p in trainer.generator.parameters())
    n_d = sum(p.numel() for p in trainer.discriminator.parameters())
    print(f"# Params - G: {n_g}, D: {n_d}")
    print(str(opt.to_dict()))
    print(f"device: {trainer.device}")

    history = []
    sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
            else lambda: None)
    t0, steps = time.perf_counter(), 0
    for step in range(1, opt.max_steps + 1):
        metrics = trainer.train_step(next(loader))
        steps += 1
        if step % P.print_every == 0:
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            sync()
            dt = time.perf_counter() - t0
            print("[Steps %7d] [G %.3f] [D %.3f] [%.1f img/s]"
                  % (step, m["G_loss"], m["D_loss"],
                     steps * opt.batch_size * opt.n_critic / max(dt, 1e-9)))
            print("  " + " ".join(f"{k}={v:.5g}" for k, v in m.items()))
            history.append(dict(m, step=step, seconds_per_step=dt / steps))
            t0, steps = time.perf_counter(), 0
    print("Training finished.")
    return history


if __name__ == "__main__":
    main()
