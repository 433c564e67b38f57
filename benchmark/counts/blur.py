"""The bytes the blur kernel must move in a train step: every launch of the
step, its input and its output once each (the byte bound of a launch; the
kernel is bound by memory, not arithmetic). Where the step blurs, and at
which shapes, is its model family's table (``blur_launches`` in
``reference/families/``: empty for a family that never blurs)."""

from __future__ import annotations

from typing import Dict, List, Tuple

Launch = Tuple[Tuple[int, int, int, int], Tuple[int, int], int, Dict[str, int]]


def launches(model: Dict, batch: int) -> List[Launch]:
    """(input shape NHWC, pads, upsample factor, launches a step by kind
    ``plain`` and ``r1``) of every blur of the step of the configuration's
    ``model`` table at ``batch``."""
    from benchmark.reference.families import make_model

    return make_model(model).blur_launches(batch)


def launch_bytes(shape, pad, itemsize: int = 4) -> int:
    """Input and output of one launch, once each."""
    n, h, w, c = shape
    ho, wo = h + sum(pad) - 3, w + sum(pad) - 3
    return itemsize * n * c * (h * w + ho * wo)


def step_bytes(model: Dict, batch: int, kind: str, itemsize: int = 4) -> int:
    return sum(per[kind] * launch_bytes(shape, pad, itemsize)
               for shape, pad, _, per in launches(model, batch))


def step_launches(model: Dict, batch: int, kind: str) -> int:
    return sum(per[kind] for _, _, _, per in launches(model, batch))
