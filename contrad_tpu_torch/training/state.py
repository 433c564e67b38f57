"""Optimiser and EMA (the port of ``contrad_tpu/training/state.py``:
``make_optimizer`` and ``ema_update``)."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_EPS = 1e-8


def _bias_correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """optax's ``1 - decay ** count``, taken in float32 (or wider) and
    rounded to the moment's dtype, which is what the moment is divided by."""
    wide = torch.promote_types(dtype, torch.float32)
    bc = 1.0 - torch.tensor(decay, dtype=wide) ** count
    return float(bc.to(dtype))


class ScheduledAdam:
    """Adam (eps 1e-8) in optax 0.2.6's order (``optax.adam``:
    ``scale_by_adam`` then the schedule), whose learning rate at update
    ``t`` (counted from 0 at the first update, as optax counts) is
    ``lr * min(1, (t + 1) / warmup) * lr_decay_fn(t)`` in float32, the
    reference's linear warmup (``train_gan.py:88-93``) times an optional
    decay. Parameters stay float32 masters; the three storage levers are the
    JAX ``make_optimizer``'s:

      * ``mu_dtype``: the first moment is kept in this dtype. The update
        promotes the stored moment against the gradient, steps with the
        moment as computed, and casts it only to store it;
      * ``nu_dtype``: the second moment is kept in this dtype, widened to
        float32 before the update and narrowed after;
      * ``grads_dtype``: gradients are cast to this dtype before anything
        else, so ``g²`` is taken in it.

    Each product and sum runs in the dtype that JAX's promotion gives it
    (a bfloat16 term times a Python scalar stays bfloat16; bfloat16 plus
    float32 is float32), so the stored moments are bit for bit those of
    optax's code run op by op (a jitted update, which keeps a bfloat16
    ``g²`` exact inside its fusion, can put ``nu`` an ulp away). One
    implementation serves every dtype, float32 (the levers off) included.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 beta: Tuple[float, float], warmup: int = 0,
                 use_warmup: bool = False,
                 lr_decay_fn: Optional[Callable[[int], float]] = None,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None,
                 grads_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.lr = lr
        self.b1, self.b2 = float(beta[0]), float(beta[1])
        self.warmup = warmup if use_warmup else 0
        self.lr_decay_fn = lr_decay_fn
        self.grads_dtype, self.nu_dtype = grads_dtype, nu_dtype
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype or p.dtype)
                   for p in self.params]

    def lr_at(self, count: int) -> float:
        lr = np.float32(self.lr)
        if self.warmup > 0:
            lr *= np.minimum(np.float32(1.0), np.float32(count + 1.0)
                             / np.float32(self.warmup))
        if self.lr_decay_fn is not None:
            lr *= np.float32(self.lr_decay_fn(count))
        return float(lr)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of ``params`` with ``grads`` (one per parameter)."""
        g = list(grads)
        if len(g) != len(self.params):
            raise ValueError(f"{len(g)} gradients for {len(self.params)} "
                             f"parameters")
        if self.grads_dtype is not None:
            g = [x.to(self.grads_dtype) for x in g]
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) * g + b1 * mu, nu = (1 - b2) * g² + b2 * nu: in
        # place on the stored moment where it has the dtype the sum is
        # computed in (the levers off, or grads as narrow as the moment);
        # otherwise into the float32 term, the stored moment cast after
        g1 = torch._foreach_mul(g, 1.0 - b1)
        mu = self._accumulate(self.mu, b1, g1)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - b2)
        if self.nu_dtype is not None:  # widened to float32 for the update
            nu = [v.float() for v in self.nu]
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2)
        else:
            nu = self._accumulate(self.nu, b2, g2)
        t = self.count + 1
        self._store(self.mu, mu)
        self._store(self.nu, nu)
        update = torch._foreach_div(mu, _bias_correction(b1, t, mu[0].dtype))
        den = torch._foreach_div(nu, _bias_correction(b2, t, nu[0].dtype))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _EPS)
        if torch.promote_types(update[0].dtype, den[0].dtype) \
                == update[0].dtype:
            torch._foreach_div_(update, den)
        else:  # a bfloat16 first moment over the float32 denominator
            update = torch._foreach_div(update, den)
        torch._foreach_mul_(update, -self.lr_at(self.count))
        torch._foreach_add_(self.params, update)
        self.count = t

    @staticmethod
    def _accumulate(stored: List[torch.Tensor], decay: float,
                    term: List[torch.Tensor]) -> List[torch.Tensor]:
        """``term + decay * stored`` in the dtype JAX's promotion gives it:
        in ``stored`` where that is its dtype, else in ``term``."""
        if torch.promote_types(term[0].dtype, stored[0].dtype) \
                == stored[0].dtype:
            torch._foreach_mul_(stored, decay)
            torch._foreach_add_(stored, term)
            return stored
        torch._foreach_add_(term, torch._foreach_mul(stored, decay))
        return term

    @staticmethod
    def _store(stored: List[torch.Tensor], new: List[torch.Tensor]) -> None:
        """The moment as computed, rounded to its storage dtype."""
        if new is not stored:
            torch._foreach_copy_(stored, new)

    def state_dict(self) -> dict:
        """The update ``count`` that the warmup and the decay read, and per
        parameter Adam's moments in their storage dtype, in
        ``torch.optim.Adam``'s layout (``step``, ``exp_avg``,
        ``exp_avg_sq``)."""
        step = torch.tensor(float(self.count))
        state = {i: {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
                 for i, (m, v) in enumerate(zip(self.mu, self.nu))}
        group = {"lr": self.lr, "betas": (self.b1, self.b2), "eps": _EPS,
                 "params": list(range(len(self.params)))}
        return {"count": self.count,
                "adam": {"state": state, "param_groups": [group]}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restores ``state_dict``'s layout; the moments are cast to this
        optimiser's storage dtypes (so a float32 checkpoint starts a lever
        run, and a lever run's moments come back bit for bit)."""
        adam = state["adam"]
        n = sum(len(g["params"]) for g in adam["param_groups"])
        if n != len(self.params):
            raise ValueError(f"the state holds {n} parameters, this "
                             f"optimiser {len(self.params)}")
        self.count = int(state["count"])
        for i, entry in adam["state"].items():
            self.mu[int(i)].copy_(entry["exp_avg"])
            self.nu[int(i)].copy_(entry["exp_avg_sq"])


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
