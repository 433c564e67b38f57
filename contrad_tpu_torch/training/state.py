"""Optimiser and EMA (the port of ``contrad_tpu/training/state.py``:
``make_optimizer`` and ``ema_update``)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import torch

_EPS = 1e-8


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never, where
    PyTorch has no CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


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

    The update count lives on the device (``count_t``, int32 as optax's),
    and the learning rate and both bias corrections are computed there from
    it, inside ``step``: the eager step and its CUDA graph
    (``training/graph.py``) run this one code path, and nothing in it reads
    a device value on the host. ``lr_decay_fn`` takes that count and
    returns a float32 tensor (or a number). ``count`` is the host mirror
    that ``state_dict`` saves: ``step`` advances it outside a graph capture,
    the graph's runner once for each replay.

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
                 lr_decay_fn: Optional[Callable[[torch.Tensor], Any]] = None,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None,
                 grads_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.lr = lr
        self.b1, self.b2 = float(beta[0]), float(beta[1])
        self.warmup = warmup if use_warmup else 0
        self.lr_decay_fn = lr_decay_fn
        self.grads_dtype, self.nu_dtype = grads_dtype, nu_dtype
        device = self.params[0].device
        # the update count, int32 as optax keeps it, on the device: the
        # learning rate and the bias corrections are taken from it there,
        # so a step captured in a CUDA graph reads the count of each replay
        self.count_t = torch.zeros((), dtype=torch.int32, device=device)
        self.count = 0  # its host mirror, for state_dict
        # the betas in float32, or the parameters' wider dtype, where the
        # bias corrections are taken
        wide = torch.promote_types(self.params[0].dtype, torch.float32)
        self.b1_t = torch.full((), self.b1, dtype=wide, device=device)
        self.b2_t = torch.full((), self.b2, dtype=wide, device=device)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype or p.dtype)
                   for p in self.params]

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The float32 learning rate at ``count`` (a device int32 scalar),
        as optax's schedule computes it."""
        lr = torch.full((), self.lr, device=count.device)
        if self.warmup > 0:
            lr = lr * torch.clamp((count + 1.0) / self.warmup, max=1.0)
        if self.lr_decay_fn is not None:
            lr = lr * self.lr_decay_fn(count)
        return lr

    def schedule(self, mu_dtype: torch.dtype, nu_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The next update's learning rate and optax's bias corrections
        ``1 - decay ** t`` (taken in float32, or wider, and rounded to each
        moment's dtype), from the device count."""
        t = (self.count_t + 1).to(self.b1_t.dtype)
        bc1 = (1.0 - torch.pow(self.b1_t, t)).to(mu_dtype)
        bc2 = (1.0 - torch.pow(self.b2_t, t)).to(nu_dtype)
        return self.lr_at(self.count_t), bc1, bc2

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
        self._store(self.mu, mu)
        self._store(self.nu, nu)
        lr, bc1, bc2 = self.schedule(mu[0].dtype, nu[0].dtype)
        update = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _EPS)
        if torch.promote_types(update[0].dtype, den[0].dtype) \
                == update[0].dtype:
            torch._foreach_div_(update, den)
        else:  # a bfloat16 first moment over the float32 denominator
            update = torch._foreach_div(update, den)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)
        self.count_t.add_(1)
        if not capturing():  # a graph's replays are counted by its runner
            self.count += 1

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
        self.count_t.fill_(self.count)
        for i, entry in adam["state"].items():
            self.mu[int(i)].copy_(entry["exp_avg"])
            self.nu[int(i)].copy_(entry["exp_avg_sq"])


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: torch.Tensor | float) -> None:
    """In place: ``e = e * decay + p * (1 - decay)`` over all parameters
    (reference ``utils.py:130-143`` accumulate), and the buffers (G's batch
    norm statistics) copied, as the JAX trainers copy G's state. ``decay``
    is a device scalar (a step captured in a CUDA graph reads each replay's
    there), or a number, taken in float32 (or the parameters' wider
    dtype)."""
    e = list(ema.parameters())
    p = list(model.parameters())
    if not isinstance(decay, torch.Tensor):
        decay = torch.full((), decay, device=e[0].device,
                           dtype=torch.promote_types(e[0].dtype,
                                                     torch.float32))
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - decay))
    for eb, b in zip(ema.buffers(), model.buffers(), strict=True):
        eb.copy_(b)
