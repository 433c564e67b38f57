"""What the train CLIs share around the train step: the run directory, the
checkpoint saved at each evaluation, ``--resume`` and ``--finetune``
(the JAX CLIs' ``train_gan.py:203-243`` and ``train_stylegan2.py:237-278``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List

import torch

from contrad_tpu_torch.config import dump_toml
from contrad_tpu_torch.utils.checkpoint import (
    find_restorable, has_checkpoint, restore_checkpoint, save_checkpoint)
from contrad_tpu_torch.utils.logger import Logger


class History(list):
    """A train CLI's result: one record per printed step (its metrics and
    the wall seconds per step since the last print), the run directory
    ``logdir`` and the checkpoints it wrote (``saves``: name, step, bytes,
    seconds)."""

    def __init__(self, logdir: str):
        super().__init__()
        self.logdir = logdir
        self.saves: List[Dict[str, Any]] = []


def add_run_args(p) -> None:
    """The flags of the run directory and its checkpoints."""
    p.add_argument("--evaluate_every", default=2000, type=int,
                   help="save ckpt/latest every this many steps")
    p.add_argument("--save_every", default=100000, type=int,
                   help="also keep ckpt/step_<N> where an evaluation step "
                        "is a multiple of this")
    p.add_argument("--no_fid", action="store_true")
    p.add_argument("--no_gif", action="store_true")
    p.add_argument("--n_eval_avg", default=3, type=int)
    p.add_argument("--comment", default="", type=str)
    p.add_argument("--logdir_root", default="logs", type=str)
    p.add_argument("--resume", default=None, type=str,
                   help="a run's logdir to continue, from its newest "
                        "completed checkpoint")
    p.add_argument("--finetune", default=None, type=str,
                   help="a run's logdir whose D (but its GAN head) starts "
                        "this run")


def open_run(P, cfg, run_name: str, subdir: str) -> Logger:
    """The run's logger: in ``--resume``'s directory, or in a new one under
    ``<logdir_root>/<subdir>/<run_name><_comment>/`` that gets the
    effective config as ``config.toml``."""
    if P.resume:
        return Logger(None, resume=P.resume, root=P.logdir_root)
    comment = f"_{P.comment}" if P.comment else ""
    logger = Logger(f"{run_name}{comment}", subdir=subdir, root=P.logdir_root)
    with open(os.path.join(logger.logdir, "config.toml"), "w") as f:
        f.write(dump_toml(cfg))
    return logger


def run_state(trainer, loader, step: int, meta: Dict[str, Any]
              ) -> Dict[str, Any]:
    """What a checkpoint holds: the trainer's state, the step, the data
    stream's position and ``meta``, what the run is."""
    return dict(trainer.state_dict(), step=step, data=loader.state_dict(),
                meta=meta)


def restore(P, trainer, loader, logger: Logger) -> int:
    """Apply ``--resume`` and ``--finetune``; returns the first step to
    run. ``--finetune`` loads D from the other run's ``latest`` and keeps
    this run's fresh GAN-head parameters (``linear``), as the JAX CLIs do;
    G, the optimisers and the step stay as they are."""
    step = 0
    if P.resume:
        name = find_restorable(P.resume)
        if name is None:
            logger.log(f"WARNING: --resume '{P.resume}' has no completed "
                       f"checkpoint; starting fresh in the same logdir")
        else:
            state = restore_checkpoint(P.resume, name, trainer.device)
            trainer.load_state_dict(state)
            loader.load_state_dict(state["data"])
            step = int(state["step"])
            logger.log(f"Checkpoint loaded from '{P.resume}/ckpt/{name}.pt' "
                       f"(step {step})")
    if P.finetune and has_checkpoint(P.finetune):
        d_state = restore_checkpoint(P.finetune, device=trainer.device)[
            "discriminator"]
        D = trainer.discriminator
        d_state.update({k: v for k, v in D.named_parameters()
                        if k.startswith("linear.")})
        D.load_state_dict(d_state)
        logger.log(f"Checkpoint loaded for fine-tuning from '{P.finetune}'")
    return step + 1


def log_start(logger: Logger, trainer, opt, first_step: int) -> None:
    n_g = sum(p.numel() for p in trainer.generator.parameters())
    n_d = sum(p.numel() for p in trainer.discriminator.parameters())
    logger.log(f"argv: {' '.join(sys.argv)}")
    logger.log(f"# Params - G: {n_g}, D: {n_d}")
    logger.log(str(opt.to_dict()))
    logger.log(f"device: {trainer.device}")
    logger.log_dirname(f"Steps {first_step}")


def evaluate(P, logger: Logger, history: History, trainer, loader, step: int,
             meta: Dict[str, Any]) -> float:
    """The evaluation at ``step``: save ``latest`` and, where ``step`` is a
    multiple of ``--save_every``, ``step_<step>``; log each checkpoint's
    size and the seconds it took. Returns the seconds spent."""
    t0 = time.perf_counter()
    logger.log_dirname(f"Steps {step + 1}")
    names = ["latest"] + ([f"step_{step}"] if step % P.save_every == 0
                          else [])
    for name in names:
        t1 = time.perf_counter()
        path = save_checkpoint(logger.logdir,
                               run_state(trainer, loader, step, meta), name)
        rec = dict(name=name, step=step, bytes=os.path.getsize(path),
                   seconds=time.perf_counter() - t1)
        history.saves.append(rec)
        logger.log(f"saved ckpt/{name}.pt: {rec['bytes'] / 2**20:.2f} MiB in "
                   f"{rec['seconds']:.3f} s")
    return time.perf_counter() - t0


def not_ported_note(P) -> str:
    return (f"not ported: in-loop FID (--evaluate_every {P.evaluate_every}, "
            f"--n_eval_avg {P.n_eval_avg}{', --no_fid' if P.no_fid else ''}) "
            f"and the progress GIF{' (--no_gif)' if P.no_gif else ''}; "
            f"evaluations save checkpoints only")


def cuda_sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
