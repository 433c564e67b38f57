"""Faults planted under the timed path, which the correctness check must
catch (``tests/test_bench_faults.py``; ``tools/readings.py --faults``).
Each takes the built :class:`~benchmark.harness.train.Program`."""

from __future__ import annotations

import numpy as np
import torch


def frozen(prog) -> None:
    """A step that returns its state unchanged: neither optimiser
    updates."""
    for opt in (prog.trainer.g_tx, prog.trainer.d_tx):
        opt.step = lambda grads: None


def half_batch(prog) -> None:
    """Half of each real batch left out, the mean taken over the rest: the
    step sees the first half twice."""
    trainer = prog.trainer
    step = trainer.train_step
    n_critic = trainer.n_critic

    def train_step(images, **kwargs):
        parts = []
        for part in images.chunk(n_critic):
            half = part[: part.shape[0] // 2]
            parts += [half, half]
        return step(torch.cat(parts), **kwargs)

    trainer.train_step = train_step


def no_r1(prog) -> None:
    """R1 left out: no step runs its penalty, lazy or not."""
    step_args = prog.step_args

    def without_r1(steps):
        args = step_args(steps)
        if "do_r1" in args:
            args["do_r1"] = np.zeros_like(args["do_r1"])
        return args

    prog.step_args = without_r1


FAULTS = {"frozen": frozen, "half_batch": half_batch, "no_r1": no_r1}
