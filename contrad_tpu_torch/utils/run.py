"""What the train CLIs share around the train step: the run directory, the
evaluation at every ``--evaluate_every`` steps with its checkpoints,
``--resume`` and ``--finetune`` (the JAX CLIs' ``train_gan.py:203-447`` and
``train_stylegan2.py:237-478``).

An evaluation does what the JAX CLIs' does, in their order:
  1. ``--n_eval_avg`` FID trials of ``fid_size`` samples each, sampled and
     embedded on the card (``evaluate/sharded.py``) with ``--fid_embed``;
  2. their row appended to ``results_fid_<eval_seed>.csv`` and the scalars
     ``gan/test/fid``, ``fid/best``, ``fid/diversity`` and ``fid/meanshift``;
  3. a frame of the fixed latents' grid added to
     ``training_progress_<eval_seed>.gif``, and the augmented reals'
     preview written to ``real_augment_<eval_seed>.png`` (PNG: the port has
     no JPEG encoder);
  4. ``ckpt/latest``; 5. ``ckpt/best`` where the score is the best so far;
  6. ``ckpt/step_<N>`` at ``--save_every``;
  7. the trackers and ``eval_seed`` in ``eval_state.npz``, which
     ``--resume`` restores.
Where the Inception weights or a statistics file cannot be found, the run
goes on without FID and says so in its log, as the JAX CLIs do (they catch
any error there; the port catches ``FileNotFoundError`` only, so that a
fault of the card or of a kernel while the statistics are computed stops
the run).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from contrad_tpu_torch.config import dump_toml
from contrad_tpu_torch.utils.checkpoint import (
    find_restorable, has_checkpoint, restore_checkpoint, save_checkpoint)
from contrad_tpu_torch.utils.logger import Logger


class History(list):
    """A train CLI's result: one record per printed step (its metrics and
    the wall seconds per step since the last print), the run directory
    ``logdir``, the checkpoints it wrote (``saves``: name, step, bytes,
    seconds) and its evaluations (``evals``: step, seconds, and the FID
    score, the best so far, whether it is the best and the seconds of the
    FID trials where FID ran)."""

    def __init__(self, logdir: str):
        super().__init__()
        self.logdir = logdir
        self.saves: List[Dict[str, Any]] = []
        self.evals: List[Dict[str, Any]] = []


def add_run_args(p) -> None:
    """The flags of the run directory and its checkpoints."""
    p.add_argument("--evaluate_every", default=2000, type=int,
                   help="evaluate and save ckpt/latest every this many steps")
    p.add_argument("--save_every", default=100000, type=int,
                   help="also keep ckpt/step_<N> where an evaluation step "
                        "is a multiple of this")
    p.add_argument("--no_fid", action="store_true")
    p.add_argument("--no_gif", action="store_true")
    p.add_argument("--n_eval_avg", default=3, type=int,
                   help="FID trials averaged at each evaluation")
    p.add_argument("--fid_embed", default="inception",
                   choices=["inception", "moments", "torch_inception"],
                   help="FID embedder: the InceptionV3 (needs its weights), "
                        "the weights-free debug 'moments' embedder, or "
                        "torch_inception, the InceptionV3 with "
                        "third_party/torch_fid's resize (no antialiasing)")
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


def restore(P, trainer, loader, logger: Logger,
            evaluation: Optional["Evaluation"] = None) -> int:
    """Apply ``--resume`` and ``--finetune``; returns the first step to
    run. ``--resume`` also restores ``evaluation``'s trackers and
    ``eval_seed`` from the run's ``eval_state.npz`` where it has one.
    ``--finetune`` loads D from the other run's ``latest`` and keeps this
    run's fresh GAN-head parameters (``linear``), as the JAX CLIs do; G,
    the optimisers and the step stay as they are."""
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
    if P.resume and evaluation is not None:
        evaluation.restore(P.resume, logger)
    return step + 1


def log_start(logger: Logger, trainer, opt, first_step: int) -> None:
    n_g = sum(p.numel() for p in trainer.generator.parameters())
    n_d = sum(p.numel() for p in trainer.discriminator.parameters())
    logger.log(f"argv: {' '.join(sys.argv)}")
    logger.log(f"# Params - G: {n_g}, D: {n_d}")
    logger.log(str(opt.to_dict()))
    logger.log(f"device: {trainer.device}")
    logger.log_dirname(f"Steps {first_step}")


class Evaluation:
    """The in-loop evaluation's trackers: FID (None where it is off or
    disabled) with its sampler on the card, the progress GIF's fixed
    latents, the preview grid and ``eval_seed``, the suffix of the files
    they write. ``use_ema`` evaluates the EMA G (the StyleGAN2 CLIs)."""

    def __init__(self, P, opt, trainer, logger: Logger, use_ema: bool):
        from contrad_tpu_torch.evaluate.visual import (
            FixedSampleGeneration, ImageGrid)

        self.trainer, self.use_ema, self.seed = trainer, use_ema, P.seed
        self.batch_size = opt.batch_size
        self.eval_seed = int(np.random.default_rng().integers(10000))
        self.fixed_gen = FixedSampleGeneration(self.generator, P.seed + 1,
                                               volatile=P.no_gif)
        self.image_grid = ImageGrid(volatile=P.no_gif)
        self.fid = self.feature_fn = None
        if P.no_fid:
            return
        from contrad_tpu_torch.evaluate.fid import FIDScore
        from contrad_tpu_torch.evaluate.sharded import make_feature_sampler

        try:
            fid = FIDScore(opt.dataset, opt.fid_size, n_avg=P.n_eval_avg,
                           embedder=P.fid_embed, device=trainer.device)
            self.feature_fn = make_feature_sampler(
                trainer, embedder=P.fid_embed, use_ema=use_ema,
                batch_per_call=min(512, opt.fid_size))
            self.fid = fid
        except FileNotFoundError as e:  # the weights or the statistics
            logger.log(f"FID disabled: {e}")

    @property
    def generator(self):
        t = self.trainer
        return t.g_ema if self.use_ema else t.generator

    def sample_from_z(self, z: torch.Tensor) -> torch.Tensor:
        """Eval-mode images of the fixed latents; a StyleGAN2 G's noise maps
        are the same at every frame."""
        from contrad_tpu_torch.models import generate

        rng = torch.Generator(device=z.device).manual_seed(self.seed + 1)
        with torch.no_grad():
            return generate(self.generator, z, noise_rng=rng)

    def preview(self, images: torch.Tensor, step: int) -> torch.Tensor:
        """The mode's augmentation of the first real batch, drawn from a
        stream seeded ``step`` (the trainer's streams are not touched)."""
        from contrad_tpu_torch.augment import AugRng
        from contrad_tpu_torch.training.step import to_float

        x = to_float(images[: self.batch_size])
        augment = self.trainer.ctx.augment
        with torch.no_grad():
            return augment.apply(x, augment.sample(
                tuple(x.shape), AugRng.from_seed(step, x.device)))

    def restore(self, logdir: str, logger: Logger) -> None:
        from contrad_tpu_torch.evaluate.persist import restore_eval_state

        seed = restore_eval_state(logdir, fid=self.fid,
                                  fixed_gen=self.fixed_gen)
        if seed is not None:
            self.eval_seed = seed
            best = (f", FID best {self.fid.best:.2f}"
                    if self.fid is not None and self.fid.history else "")
            logger.log(f"Eval state restored (eval_seed {seed}{best})")


def evaluate(P, logger: Logger, history: History, trainer, loader, step: int,
             meta: Dict[str, Any], evaluation: Evaluation,
             images: torch.Tensor) -> float:
    """The evaluation at ``step`` (see the module docstring), ``images``
    the step's real batch; logs each checkpoint's size and the seconds it
    took. Returns the seconds spent."""
    from contrad_tpu_torch.evaluate.persist import save_eval_state
    from contrad_tpu_torch.evaluate.visual import write_png

    t0 = time.perf_counter()
    logger.log_dirname(f"Steps {step + 1}")
    ev, fid, rec = evaluation, evaluation.fid, dict(step=step)
    if fid is not None:
        avg = fid.update(step, feature_fn=ev.feature_fn)
        rec.update(fid=avg, fid_best=fid.best, is_best=fid.is_best,
                   fid_seconds=time.perf_counter() - t0)
        fid.save(os.path.join(logger.logdir,
                              f"results_fid_{ev.eval_seed}.csv"))
        for tag, value in (("", avg), ("/best", fid.best),
                           ("/diversity", fid.last_diversity),
                           ("/meanshift", fid.last_meanshift)):
            logger.scalar_summary("gan/test/fid" + tag, value, step)
        logger.log(f"FID {avg:.4f} (best {fid.best:.4f}) in "
                   f"{rec['fid_seconds']:.2f} s")
    if not P.no_gif:
        ev.fixed_gen.update(ev.sample_from_z)
        ev.fixed_gen.write_gif(os.path.join(
            logger.logdir, f"training_progress_{ev.eval_seed}.gif"))
        write_png(os.path.join(logger.logdir,
                               f"real_augment_{ev.eval_seed}.png"),
                  ev.image_grid.update(ev.preview(images, step)))
    names = (["latest"] + (["best"] if fid is not None and fid.is_best
                           else [])
             + ([f"step_{step}"] if step % P.save_every == 0 else []))
    for name in names:
        t1 = time.perf_counter()
        path = save_checkpoint(logger.logdir,
                               run_state(trainer, loader, step, meta), name)
        save = dict(name=name, step=step, bytes=os.path.getsize(path),
                    seconds=time.perf_counter() - t1)
        history.saves.append(save)
        logger.log(f"saved ckpt/{name}.pt: {save['bytes'] / 2**20:.2f} MiB "
                   f"in {save['seconds']:.3f} s")
    save_eval_state(logger.logdir, ev.eval_seed, fid=fid,
                    fixed_gen=ev.fixed_gen)
    rec["seconds"] = time.perf_counter() - t0
    history.evals.append(rec)
    return rec["seconds"]


def cuda_sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
