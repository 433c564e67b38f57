"""StyleGAN2 + ContraD training CLI of the port (the counterpart of the
repo root's ``train_stylegan2.py``):

    python -m contrad_tpu_torch.train_stylegan2 \\
        configs/gan/stylegan2/c10_style64.toml stylegan2 \\
        --mode contrad --aug simclr --lbd_r1 0.1 --no_lazy --halflife_k 1000 \\
        --use_warmup

It reads the same TOML configs, prints and logs the same scalar names
(``D_loss``, ``D_penalty``, ``D_real``, ``D_gen``, ``D_r1``, ``G_loss``) and
writes the same run directory as the JAX CLI,
``<logdir_root>/gan_dp/st_<config stem>/<architecture>/<run name>/<rand>/``
(``config.toml``, ``log.txt``, ``scalars.jsonl``, ``ckpt/``), with the
evaluation (FID of the EMA G, the progress GIF, ``ckpt/best``),
``--evaluate_every``, ``--save_every``, ``--resume`` and ``--finetune`` as
``train_gan``'s. ``--penalty`` (``gp``, ``cr``, ``bcr``) adds a D penalty
to the first critic sub-step, with the config's ``lbd`` and ``lbd2``. It
runs on the card; ``--device cpu`` runs it on the CPU. ``--dtype``,
``--opt_moments``, ``--opt_nu`` and ``--opt_grads`` are ``train_gan``'s
(the production configuration: all four ``bf16``). The port has no packed
layouts: ``--no_packed_aug``, the JAX CLI's switch to the unpacked path, is
accepted and changes nothing (the log says so). ``--steps_per_dispatch`` and
``--trace_steps`` are ``train_gan``'s; in a block of K steps the lazy R1 and
the EMA gate are per-step vectors, and each step replays the CUDA graph of
its kind (plain, or with R1). ``--multihost`` is ``train_gan``'s; the
global batch's rows a rank must be a multiple of the minibatch stddev's
group (4, or the global batch where smaller).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from contrad_tpu_torch.utils.run import (
    History, add_precision_args, add_run_args)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="StyleGAN2 training on PyTorch")
    p.add_argument("config", type=str)
    p.add_argument("architecture", type=str,
                   help="stylegan2 | stylegan2_512 | stylegan2_tiny | "
                        "stylegan3_t_512 | stylegan3_t_tiny")
    p.add_argument("--mode", default="contrad", type=str)
    p.add_argument("--penalty", default="none", type=str,
                   help="none | gp | cr | bcr")
    p.add_argument("--aug", default="none", type=str)
    p.add_argument("--use_warmup", action="store_true")
    p.add_argument("--temp", default=0.1, type=float)
    p.add_argument("--lbd_a", default=1.0, type=float)
    p.add_argument("--no_lazy", action="store_true",
                   help="R1 every step instead of every d_reg_every")
    p.add_argument("--d_reg_every", default=16, type=int)
    p.add_argument("--lbd_r1", default=10.0, type=float)
    p.add_argument("--style_mix", default=0.9, type=float)
    p.add_argument("--halflife_k", default=20, type=int,
                   help="EMA half-life in thousands of images")
    p.add_argument("--ema_start_k", default=None, type=int)
    p.add_argument("--halflife_lr", default=0, type=int,
                   help="LR half-life in images; 0 disables decay")
    p.add_argument("--no_packed_aug", action="store_true",
                   help="the JAX CLI's switch to the unpacked train path, "
                        "which is the port's only path: accepted, changes "
                        "nothing")
    p.add_argument("--print_every", default=50, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_precision_args(p)
    add_run_args(p)
    return p.parse_args(argv)


def build(P: argparse.Namespace):
    """Config, data stream and trainer for the parsed arguments."""
    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.config import (
        default_config_files, finalize_options, load_config)
    from contrad_tpu_torch.data import get_dataset, make_train_loader
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import ScheduledAdam, StyleGAN2Trainer
    from contrad_tpu_torch.utils.run import (
        check_world, join_world, optimizer_levers)

    device = join_world(P)
    cfg = finalize_options(load_config(default_config_files(P.config),
                                       P.override))
    opt = cfg.options
    if P.no_lazy:
        P.d_reg_every = 1
    if P.ema_start_k is None:
        P.ema_start_k = P.halflife_k

    train_set, _, image_size = get_dataset(opt.dataset)
    generator, discriminator = get_architecture(P.architecture, image_size,
                                                device=device, seed=P.seed,
                                                dtype=P.dtype,
                                                batch_size=opt.batch_size)

    def lr_decay_fn(count: int) -> float:
        # stepped half-life decay (reference train_stylegan2.py:93-103)
        if P.halflife_lr <= 0:
            return 1.0
        return 0.5 ** ((count // 1000) * 1000 * opt.batch_size / P.halflife_lr)

    def adam(module, lr):
        return ScheduledAdam(module.parameters(), lr, tuple(opt.beta),
                             warmup=opt.warmup, use_warmup=P.use_warmup,
                             lr_decay_fn=lr_decay_fn, **optimizer_levers(P))

    trainer = StyleGAN2Trainer(
        generator, discriminator, mode=P.mode,
        augment=get_augment(P.aug, cfg.get("augment")),
        g_optimizer=adam(generator, opt.lr),
        d_optimizer=adam(discriminator, opt.lr_d),
        loss_type=opt.loss, penalty=P.penalty, temp=P.temp, lbd_a=P.lbd_a,
        lbd=opt.lbd, lbd2=opt.lbd2, lbd_r1=P.lbd_r1,
        d_reg_every=P.d_reg_every, style_mix=P.style_mix,
        n_critic=opt.n_critic,
        real_augment=(get_augment("hflip") if train_set.train_aug == "hflip"
                      else None),
        seed=P.seed)
    check_world(P, opt, discriminator)
    loader = make_train_loader(train_set, opt.batch_size, opt.n_critic,
                               seed=P.seed, device=device)
    return cfg, loader, trainer


def ema_accum(P, batch_size: int) -> float:
    """The EMA decay of a step once the gate is open (reference
    ``train_stylegan2.py:154``)."""
    return 0.5 ** (batch_size / (P.halflife_k * 1000))


def step_args(P, batch_size: int, steps: np.ndarray) -> dict:
    """The lazy-R1 flag and the EMA decay of each step in ``steps`` (JAX's
    ``r1_block`` and ``ema`` vectors, ``train_stylegan2.py:387-396``),
    for the parsed arguments after ``build``."""
    return dict(do_r1=(steps % P.d_reg_every == 0) & (P.lbd_r1 > 0),
                ema_decay=np.where(steps * batch_size > P.ema_start_k * 1000,
                                   ema_accum(P, batch_size), 0.0))


def main(argv: Optional[Sequence[str]] = None) -> History:
    """Train up to ``options.max_steps`` steps; returns the
    :class:`~contrad_tpu_torch.utils.run.History`: one record per printed
    step (its metrics and the wall seconds per step since the last print,
    checkpoint writes excluded), the logdir and the checkpoints written."""
    from contrad_tpu_torch.parallel import shutdown
    from contrad_tpu_torch.training.modes import run_filename
    from contrad_tpu_torch.utils import run

    P = parse_args(argv)
    cfg, loader, trainer = build(P)
    opt = cfg.options
    accum = ema_accum(P, opt.batch_size)
    desc = f"R{P.lbd_r1}_mix{P.style_mix}_H{P.halflife_k}"
    if P.halflife_lr > 0:
        desc += f"_lr{P.halflife_lr / 1e6:.1f}M"
    desc += "_NoLazy" if P.no_lazy else "_Lazy"
    name = run_filename(P.mode, P.penalty, P.aug, P.temp, P.lbd_a)
    logger = run.open_run(
        P, cfg, f"{name}_{desc}",
        f"gan_dp/st_{Path(P.config).stem}/{P.architecture}")
    evaluation = run.Evaluation(P, opt, trainer, logger, use_ema=True)
    first = run.restore(P, trainer, loader, logger, evaluation)
    meta = dict(architecture=P.architecture, n_classes=trainer.n_classes)
    run.log_start(logger, P, trainer, opt, first)
    logger.log(f"Use G moving average: {accum}")
    if P.no_packed_aug:
        logger.log("--no_packed_aug: the port trains on unpacked NHWC "
                   "tensors only; the flag changes nothing")

    history = run.train(P, opt, trainer, loader, logger, evaluation, meta,
                        first, lambda steps: step_args(P, opt.batch_size,
                                                       steps))
    shutdown()
    return history


if __name__ == "__main__":
    main()
