"""What the train CLIs share around the train step: the run directory, the
train loop (:func:`train`: multi-step dispatch and ``--trace_steps``), the
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

In a world of processes (``--multihost``) rank 0 alone writes the run
directory, its logs, CSV and checkpoints, with a barrier around each save;
every rank restores on ``--resume``. The in-loop FID is collective: every
rank samples its share and the features are gathered; ``world_all``
decides whether it runs at all and ``broadcast_floats`` settles the score,
the best and whether it is the best from rank 0's (the JAX CLIs'
``train_gan.py:305-315,405-415``). The progress GIF and the augmentation
preview are off, as in JAX (``train_gan.py:158-165``). A gloo world cannot
capture its collectives in a CUDA graph, so it runs the eager step.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from contrad_tpu_torch.config import dump_toml
from contrad_tpu_torch.parallel import (
    barrier, broadcast_floats, broadcast_object, data_shard, world_all)
from contrad_tpu_torch.parallel.mesh import backend
from contrad_tpu_torch.utils.checkpoint import (
    find_restorable, has_checkpoint, restore_checkpoint, save_checkpoint)
from contrad_tpu_torch.utils.logger import Logger, RankLogger


class History(list):
    """A train CLI's result: one record per printed step (its metrics and
    the wall seconds per step since the last print, over every step of the
    blocks in between), the run directory ``logdir``, the checkpoints it
    wrote (``saves``: name, step, bytes, seconds), its evaluations
    (``evals``: step, seconds, and the FID score, the best so far, whether
    it is the best and the seconds of the FID trials where FID ran) and its
    multi-step dispatch (``dispatch``: K, and the graph runner's ``stats``:
    warm-up steps, capture seconds, launches and replays per step kind) and
    its data path (``data``: the loader's ``path`` and, host-fed, its
    prefetch ``stats``)."""

    def __init__(self, logdir: str):
        super().__init__()
        self.logdir = logdir
        self.saves: List[Dict[str, Any]] = []
        self.evals: List[Dict[str, Any]] = []
        self.dispatch: Dict[str, Any] = {}
        self.data: Dict[str, Any] = {}


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
    p.add_argument("--steps_per_dispatch", default=0, type=int,
                   help="Run K train steps per dispatch (on the card K "
                        "replays of the step's CUDA graphs, enqueued with no "
                        "host sync; on the CPU K eager steps). 0 = auto: the "
                        "largest K <= 16 dividing every event cadence. 1 "
                        "disables (the eager step).")
    p.add_argument("--trace_steps", default=0, type=int,
                   help="Capture a torch.profiler trace (CPU and CUDA "
                        "activity) of N steps, written to <logdir>/profile "
                        "(view with tensorboard); runs the eager step")
    p.add_argument("--multihost", action="store_true",
                   help="Join a world of processes, one per card (torchrun, "
                        "or CONTRAD_COORDINATOR / CONTRAD_NUM_PROCESSES / "
                        "CONTRAD_PROCESS_ID): data parallel over the global "
                        "batch, NCCL on cuda, gloo with --device cpu")


def add_precision_args(p) -> None:
    """The compute dtype and Adam's three storage levers, with the JAX
    CLIs' choices and defaults (``train_gan.py:77-90``,
    ``train_stylegan2.py:86-98``); the production configuration is all four
    at ``bf16``."""
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="model compute dtype (params stay f32; bf16 is the "
                        "mixed-precision path, loss math stays f32)")
    p.add_argument("--opt_moments", default="f32", choices=["f32", "bf16"],
                   help="Adam first-moment storage dtype (params stay f32 "
                        "masters; bf16 halves mu memory traffic)")
    p.add_argument("--opt_grads", default="f32", choices=["f32", "bf16"],
                   help="gradient dtype entering Adam (update math stays "
                        "f32; nu's g^2 is taken in this dtype)")
    p.add_argument("--opt_nu", default="f32", choices=["f32", "bf16"],
                   help="Adam second-moment storage dtype (A/B lever; bf16 "
                        "risks freezing a warm nu)")


def optimizer_levers(P) -> Dict[str, Optional[torch.dtype]]:
    """``ScheduledAdam``'s storage dtypes for the parsed flags."""
    from contrad_tpu_torch import reduced_dtype

    return {"mu_dtype": reduced_dtype(P.opt_moments),
            "nu_dtype": reduced_dtype(P.opt_nu),
            "grads_dtype": reduced_dtype(P.opt_grads)}


def join_world(P):
    """The device the CLI trains on: with ``--multihost`` this process's
    card of the world it joins (``parallel.init_distributed``), else
    ``--device``."""
    from contrad_tpu_torch import resolve_device
    from contrad_tpu_torch.parallel import init_distributed

    return (init_distributed(P.device) if getattr(P, "multihost", False)
            else resolve_device(P.device))


def check_world(P, opt, discriminator) -> None:
    """What a world asks of the run, at start-up: a global batch that
    divides by the world (the JAX CLIs' error text), and, for a
    discriminator with a minibatch stddev, groups that stay on one rank;
    the progress GIF and the augmentation preview off."""
    from contrad_tpu_torch.models.stylegan2.discriminator import (
        ResidualBackbone, stddev_group_size)

    rank, world = data_shard()
    if opt.batch_size % world:
        raise ValueError(f"global batch {opt.batch_size} must divide device "
                         f"count {world}")
    if world > 1 and isinstance(discriminator.backbone, ResidualBackbone):
        stddev_group_size(opt.batch_size // world, world)
    if world > 1 and not P.no_gif:
        print(f"[multihost rank {rank}] in-loop GIF/aug-preview disabled "
              f"({world} processes); FID runs collectively", flush=True)
        P.no_gif = True


def open_run(P, cfg, run_name: str, subdir: str):
    """The run's logger: in ``--resume``'s directory, or in a new one under
    ``<logdir_root>/<subdir>/<run_name><_comment>/`` that gets the
    effective config as ``config.toml``. In a world rank 0 makes it and the
    other ranks get a :class:`RankLogger` of the same directory."""
    logger = None
    if data_shard()[0] == 0:
        if P.resume:
            logger = Logger(None, resume=P.resume, root=P.logdir_root)
        else:
            comment = f"_{P.comment}" if P.comment else ""
            logger = Logger(f"{run_name}{comment}", subdir=subdir,
                            root=P.logdir_root)
            with open(os.path.join(logger.logdir, "config.toml"), "w") as f:
                f.write(dump_toml(cfg))
    logdir = broadcast_object(None if logger is None else logger.logdir)
    return logger if logger is not None else RankLogger(logdir)


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


def log_start(logger: Logger, P, trainer, opt, first_step: int) -> None:
    n_g = sum(p.numel() for p in trainer.generator.parameters())
    n_d = sum(p.numel() for p in trainer.discriminator.parameters())
    logger.log(f"argv: {' '.join(sys.argv)}")
    logger.log(f"precision: dtype {P.dtype}, opt_moments {P.opt_moments}, "
               f"opt_nu {P.opt_nu}, opt_grads {P.opt_grads}")
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

        # in a world rank 0 goes first: it computes the reference
        # statistics where they are not cached, the other ranks read them
        first = data_shard()[0] == 0
        if not first:
            barrier()
        fid = None
        try:
            fid = FIDScore(opt.dataset, opt.fid_size, n_avg=P.n_eval_avg,
                           embedder=P.fid_embed, device=trainer.device)
        except FileNotFoundError as e:  # the weights or the statistics
            logger.log(f"FID disabled: {e}")
        if first:
            barrier()
        if not world_all(fid is not None):
            if fid is not None:
                logger.log("FID disabled: not available on every process")
            return
        self.feature_fn = make_feature_sampler(
            trainer, embedder=P.fid_embed, use_ema=use_ema,
            batch_per_call=min(512, opt.fid_size))
        self.fid = fid

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
    writer = data_shard()[0] == 0
    if fid is not None:
        avg = fid.update(step, feature_fn=ev.feature_fn)
        # rank 0's score: host sqrtm and np.cov may differ in the last ulps
        # between ranks, and a diverged is_best would desynchronise the
        # checkpoint writes below
        avg, fid.best, is_best = broadcast_floats(avg, fid.best,
                                                  float(fid.is_best))
        fid.is_best = bool(is_best)
        fid.history[-1][-1] = avg
        rec.update(fid=avg, fid_best=fid.best, is_best=fid.is_best,
                   fid_seconds=time.perf_counter() - t0)
        if writer:
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
        barrier()
        t1 = time.perf_counter()
        if writer:
            save_checkpoint(logger.logdir,
                            run_state(trainer, loader, step, meta), name)
        barrier()
        path = os.path.join(logger.logdir, "ckpt", f"{name}.pt")
        save = dict(name=name, step=step, bytes=os.path.getsize(path),
                    seconds=time.perf_counter() - t1)
        history.saves.append(save)
        logger.log(f"saved ckpt/{name}.pt: {save['bytes'] / 2**20:.2f} MiB "
                   f"in {save['seconds']:.3f} s")
    if writer:
        save_eval_state(logger.logdir, ev.eval_seed, fid=fid,
                        fixed_gen=ev.fixed_gen)
    rec["seconds"] = time.perf_counter() - t0
    history.evals.append(rec)
    return rec["seconds"]


def cuda_sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def start_trace(logdir: str, device: torch.device):
    """A running torch.profiler (CPU activity, and CUDA on the card) that
    writes its trace under ``<logdir>/profile`` when stopped."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities, on_trace_ready=(
        tensorboard_trace_handler(os.path.join(logdir, "profile"))))
    prof.start()
    return prof


def train(P, opt, trainer, loader, logger: Logger, evaluation: Evaluation,
          meta: Dict[str, Any], first: int, step_args=None) -> History:
    """The train loop of both train CLIs (the JAX CLIs' ``train_gan.py:
    336-447`` and ``train_stylegan2.py:365-478``): steps ``first`` to
    ``options.max_steps`` in the blocks of :class:`~contrad_tpu_torch.
    training.dispatch.BlockDispatcher`, run by :class:`~contrad_tpu_torch.
    training.graph.BlockRunner` (CUDA graphs on the card where K > 1); print,
    evaluate and save at their exact steps, reading the block's last step;
    ``--trace_steps`` as a torch.profiler trace. ``step_args(steps)`` gives
    the runner's per-step ``ema_decay`` and ``do_r1`` for an array of step
    numbers. Returns the :class:`History`."""
    from contrad_tpu_torch.training.dispatch import (
        BlockDispatcher, resolve_steps_per_dispatch)
    from contrad_tpu_torch.training.graph import BlockRunner

    if backend() == "gloo":
        if P.steps_per_dispatch > 1:
            raise ValueError(
                f"--steps_per_dispatch {P.steps_per_dispatch}: a gloo world "
                f"cannot capture its collectives in a CUDA graph; use 0 or 1")
        logger.log("Multi-step dispatch: 1 step/program (a gloo world runs "
                   "the eager step)")
        k_dispatch = 1
    else:
        k_dispatch = resolve_steps_per_dispatch(
            P.steps_per_dispatch, getattr(loader, "supports_indexed", False),
            P.trace_steps, P.print_every, P.evaluate_every, P.save_every)
    dispatcher = BlockDispatcher(loader, k_dispatch, opt.max_steps)
    if k_dispatch > 1:
        logger.log(f"Multi-step dispatch: {k_dispatch} steps/program")
    path = getattr(loader, "path", type(loader).__name__)
    logger.log(f"Data path: {path} ({type(loader).__name__})")
    runner = BlockRunner(trainer, loader)
    history = History(logger.logdir)
    history.dispatch = dict(k=k_dispatch, stats=runner.stats)
    history.data = dict(path=path, stats=getattr(loader, "stats", {}))
    writer = data_shard()[0] == 0
    trace = (start_trace(logger.logdir, trainer.device)
             if P.trace_steps > 0 and writer else None)
    sync = cuda_sync(trainer.device)
    t0, steps, step = time.perf_counter(), 0, first
    while step <= opt.max_steps:
        blk = dispatcher.next_block(step)
        batches = None
        if blk.kind == "block":
            idx, labels = blk.idx_block, blk.labels_block
        elif blk.kind == "batch":  # a host-fed batch, already on the device
            idx, labels, batches = None, [blk.labels], [blk.materialize()]
        else:
            idx, labels = [blk.idx], [blk.labels]
        args = step_args(np.arange(step, step + blk.k)) if step_args else {}
        metrics = runner.run(idx, labels if trainer.conditional else None,
                             batches=batches, **args)
        t0 += runner.take_setup_seconds()
        step += blk.k - 1  # `step` is now the block's LAST step
        steps += blk.k
        if trace is not None and step == first + P.trace_steps:
            sync()
            trace.stop()
            trace = None
            logger.log(f"Profiler trace written to {logger.logdir}/profile")
        if step % P.print_every == 0:
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            sync()
            dt = time.perf_counter() - t0
            logger.log("[Steps %7d] [G %.3f] [D %.3f] [%.1f img/s]"
                       % (step, m["G_loss"], m["D_loss"], steps
                          * opt.batch_size * opt.n_critic / max(dt, 1e-9)))
            if writer:
                print("  " + " ".join(f"{k}={v:.5g}" for k, v in m.items()))
            for name, value in m.items():
                logger.scalar_summary("gan/train/" + name, value, step)
            history.append(dict(m, step=step, seconds_per_step=dt / steps))
            t0, steps = time.perf_counter(), 0
        if step % P.evaluate_every == 0:
            t0 += evaluate(P, logger, history, trainer, loader, step, meta,
                           evaluation, blk.materialize())
        step += 1
    if trace is not None:  # the run ended inside the traced steps
        sync()
        trace.stop()
        logger.log(f"Profiler trace written to {logger.logdir}/profile")
    if hasattr(loader, "close"):  # a host-fed loader's worker thread
        loader.close()
    if trainer.device.type == "cuda":
        logger.log(f"peak device memory: "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    logger.log("Training finished.")
    logger.close()
    return history
