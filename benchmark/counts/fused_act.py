"""The bytes the fused bias + leaky ReLU + gain kernel must move in a
train step: every launch of the step reads its inputs once and writes its
outputs once (the byte bound of a launch; the kernel is bound by memory,
not arithmetic). Where the step runs it, and at which shapes, is its model
family's table (``fused_act_launches`` in ``reference/families/``: empty
for a family that never runs it). A row is ``(shape, op, launches a step
by kind plain and r1)``, channels last, ``op`` one of

* ``act``, the forward: ``x`` and the ``(C,)`` bias in, the output out;
* ``grad``, a gradient: ``dy`` and the forward's saved output in, ``dx``
  out;
* ``bias_sum``, the bias gradient's launch after a ``grad``: the ``(C,)``
  sum out. The partial sums it reads, which the ``grad`` launch writes,
  are the kernel's own work split and are not counted."""

from __future__ import annotations

from typing import Dict, List, Tuple

Launch = Tuple[Tuple[int, ...], str, Dict[str, int]]


def launches(model: Dict, batch: int) -> List[Launch]:
    """Every launch of the fused activation in a step of the
    configuration's ``model`` table at ``batch``."""
    from benchmark.reference.families import make_model

    return make_model(model).fused_act_launches(batch)


def launch_bytes(shape, op: str, itemsize: int = 4) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    c = int(shape[-1])
    values = {"act": 2 * n + c, "grad": 3 * n, "bias_sum": c}[op]
    return itemsize * values


def step_bytes(model: Dict, batch: int, kind: str, itemsize: int = 4) -> int:
    return sum(per[kind] * launch_bytes(shape, op, itemsize)
               for shape, op, per in launches(model, batch))


def step_launches(model: Dict, batch: int, kind: str) -> int:
    return sum(per[kind] for _, _, per in launches(model, batch))
