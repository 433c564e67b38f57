"""Optimiser and EMA (the port of ``contrad_tpu/training/state.py``:
``make_optimizer`` and ``ema_update``)."""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch


class ScheduledAdam:
    """Adam (eps 1e-8) whose learning rate at update ``t`` (counted from 0
    at the first update, as optax counts) is
    ``lr * min(1, (t + 1) / warmup) * lr_decay_fn(t)``, the reference's
    linear warmup (``train_gan.py:88-93``) times an optional decay."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 beta: Tuple[float, float], warmup: int = 0,
                 use_warmup: bool = False,
                 lr_decay_fn: Optional[Callable[[int], float]] = None):
        self.params = list(params)
        self.lr = lr
        self.warmup = warmup if use_warmup else 0
        self.lr_decay_fn = lr_decay_fn
        self.count = 0
        self.opt = torch.optim.Adam(self.params, lr=lr,
                                    betas=(float(beta[0]), float(beta[1])),
                                    eps=1e-8)

    def lr_at(self, count: int) -> float:
        lr = self.lr
        if self.warmup > 0:
            lr *= min(1.0, (count + 1.0) / self.warmup)
        if self.lr_decay_fn is not None:
            lr *= self.lr_decay_fn(count)
        return lr

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of ``params`` with ``grads`` (one per parameter)."""
        for p, g in zip(self.params, grads, strict=True):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        """Adam's moments and step per parameter, and the update ``count``
        that the warmup and the decay read."""
        return {"count": self.count, "adam": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["adam"])


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """In place: ``e = e * decay + p * (1 - decay)`` over all parameters
    (reference ``utils.py:130-143`` accumulate), and the buffers (G's batch
    norm statistics) copied, as the JAX trainers copy G's state."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, list(model.parameters()), alpha=1.0 - decay)
    for eb, b in zip(ema.buffers(), model.buffers(), strict=True):
        eb.copy_(b)
