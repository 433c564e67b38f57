"""GAN training CLI of the port (the counterpart of the repo root's
``train_gan.py``), the SNDCGAN + ContraD flagship:

    python -m contrad_tpu_torch.train_gan \\
        configs/gan/cifar10/c10_b512.toml sndcgan \\
        --mode contrad --aug simclr --use_warmup

It reads the same TOML configs, prints and logs the same scalar names
(``D_loss``, ``D_penalty``, ``D_real``, ``D_gen``, ``G_loss``) and writes
the same run directory, ``<logdir_root>/gan/<config stem>/<architecture>/
<run name>/<rand>/`` with ``config.toml`` (the effective config),
``log.txt``, ``scalars.jsonl`` and ``ckpt/``. Every ``--evaluate_every``
steps it evaluates as the JAX CLI does (``utils/run.py``): FID with
``--fid_embed`` (``--n_eval_avg`` trials; ``--no_fid`` skips it) into
``results_fid_<eval_seed>.csv``, a frame of ``training_progress_
<eval_seed>.gif`` (``--no_gif`` skips it), ``ckpt/latest.pt``,
``ckpt/best.pt`` at the best FID, ``ckpt/step_<N>.pt`` where the step is a
multiple of ``--save_every``, and ``eval_state.npz``. ``--resume <logdir>``
continues a run from its newest completed checkpoint and its evaluation
state (the same command line, ``options.max_steps`` raised);
``--finetune <logdir>`` starts D from another run's, its GAN head fresh.
``--conditional`` trains a class-conditional D (projection discrimination)
on a labelled dataset. Any architecture of the registry runs, StyleGAN2's
included, as in the JAX CLI. It runs on the card; ``--device cpu`` runs it
on the CPU. ``--dtype bf16`` computes in bfloat16 (parameters stay
float32 masters, the loss math float32) and ``--opt_moments``, ``--opt_nu``
and ``--opt_grads`` set Adam's storage dtypes; the production
configuration is all four at ``bf16``. ``--steps_per_dispatch K`` runs K
steps a dispatch, as CUDA graph replays on the card (0, the default, picks
the largest K <= 16 that divides every cadence; 1 is the eager step), and
``--trace_steps N`` writes a torch.profiler trace under
``<logdir>/profile`` of the run's own blocks (graph replays at its K on the
card) up to the first block boundary at or after N steps, the step's
phases marked on the device beside the loop's host spans
(``utils/run.py::train``, ``utils/trace.py``). ``--multihost`` joins a
world of processes, one per card (torchrun, or the ``CONTRAD_*``
rendezvous of ``hostenv.spawn_world``; NCCL, or gloo with ``--device
cpu``): each rank trains on its rows of the global batch and the step
computes the global batch's function (``contrad_tpu_torch/parallel``).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from contrad_tpu_torch.utils.run import (
    History, add_precision_args, add_run_args)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GAN training on PyTorch")
    p.add_argument("config", type=str)
    p.add_argument("architecture", type=str,
                   help="sndcgan | snresnet18 | stylegan2 | stylegan2_512 | "
                        "stylegan2_tiny")
    p.add_argument("--mode", default="std", type=str,
                   help="std | aug | aug_both | simclr_only | contrad")
    p.add_argument("--penalty", default="none", type=str,
                   help="none | gp | cr | bcr")
    p.add_argument("--aug", default="none", type=str)
    p.add_argument("--use_warmup", action="store_true")
    p.add_argument("--conditional", action="store_true",
                   help="class-conditional D (projection y-head): real labels "
                        "from the dataset, fake labels drawn uniformly")
    p.add_argument("--temp", default=0.1, type=float)
    p.add_argument("--lbd_a", default=1.0, type=float)
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
    from contrad_tpu_torch.training import GANTrainer, ScheduledAdam
    from contrad_tpu_torch.utils.run import (
        check_world, join_world, optimizer_levers)

    device = join_world(P)
    cfg = finalize_options(load_config(default_config_files(P.config),
                                       P.override))
    opt = cfg.options
    train_set, _, image_size = get_dataset(opt.dataset)
    if P.conditional and train_set.n_classes <= 1:
        raise ValueError(
            f"--conditional requires a labeled dataset; '{opt.dataset}' "
            f"reports n_classes={train_set.n_classes}")
    n_classes = train_set.n_classes if P.conditional else 1
    generator, discriminator = get_architecture(P.architecture, image_size,
                                                device=device, seed=P.seed,
                                                n_classes=n_classes,
                                                dtype=P.dtype)

    def adam(module, lr):
        return ScheduledAdam(module.parameters(), lr, tuple(opt.beta),
                             warmup=opt.warmup, use_warmup=P.use_warmup,
                             **optimizer_levers(P))

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
    check_world(P, opt, discriminator)
    loader = make_train_loader(train_set, opt.batch_size, opt.n_critic,
                               seed=P.seed, device=device,
                               with_labels=P.conditional)
    return cfg, loader, trainer


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
    logger = run.open_run(
        P, cfg, run_filename(P.mode, P.penalty, P.aug, P.temp, P.lbd_a),
        f"gan/{Path(P.config).stem}/{P.architecture}")
    evaluation = run.Evaluation(P, opt, trainer, logger, use_ema=False)
    first = run.restore(P, trainer, loader, logger, evaluation)
    meta = dict(architecture=P.architecture, n_classes=trainer.n_classes)
    run.log_start(logger, P, trainer, opt, first)
    history = run.train(P, opt, trainer, loader, logger, evaluation, meta,
                        first)
    shutdown()
    return history


if __name__ == "__main__":
    main()
