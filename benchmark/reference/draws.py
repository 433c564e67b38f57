"""Random draws of the reference step.

The step under test draws every random number of a step (latents, noise
maps, style mixing, augmentation parameters) from one ``torch.Generator`` on
the card, seeded with the run's seed, in a fixed order. The reference makes
the same calls, with the same shapes and in the same order, on a generator
of its own seeded alike, so it works every draw out again and takes none
from the program. ``Rand(None, "meta")`` gives empty tensors of the same
shapes: the FLOP counter runs the step on the meta device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def derive(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of the run's ``seed`` (weights,
    images), apart from the step's own stream."""
    state = np.random.SeedSequence([int(seed), int(tag)]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


class Rand:
    """``torch.rand``, ``torch.randn`` and ``torch.randint`` on ``gen``."""

    def __init__(self, gen: Optional[torch.Generator],
                 device: str | torch.device):
        self.gen, self.device = gen, torch.device(device)

    @classmethod
    def from_seed(cls, seed: int, device: str | torch.device) -> "Rand":
        device = torch.device(device)
        if device.type == "meta":
            return cls(None, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return cls(gen, device)

    def rand(self, shape: Sequence[int]) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), device=self.device)
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)

    def randn(self, shape: Sequence[int]) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), device=self.device)
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def randint(self, lo: int, hi: int, shape: Sequence[int]) -> torch.Tensor:
        if self.gen is None:
            return torch.zeros(tuple(shape), dtype=torch.int64,
                               device=self.device)
        return torch.randint(lo, hi, tuple(shape), generator=self.gen,
                             device=self.device)

    def uniform(self, shape: Sequence[int], lo: float = 0.0,
                hi: float = 1.0) -> torch.Tensor:
        return self.rand(shape) * (hi - lo) + lo


def batch_rows(seed: int, n: int, rows: int, step: int) -> np.ndarray:
    """The dataset rows of train step ``step`` (1-based): each epoch a
    permutation of the ``n`` rows drawn from ``default_rng((seed, epoch))``,
    cut into batches of ``rows``, the last short one dropped."""
    per_epoch = n // rows
    epoch, i = divmod(step - 1, per_epoch)
    order = np.random.default_rng((int(seed), epoch)).permutation(n)
    return order[i * rows:(i + 1) * rows]
