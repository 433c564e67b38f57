"""The FLOPs of a train step's convolutions and matrix products, forward
and backward as the step takes them (weight and input gradients where it
needs them, R1's gradient of a gradient), counted from the shapes by
``torch.utils.flop_counter`` on the reference step run on the meta device.
The augmentations are left out (their resampling is a data transform, not
the models' work), and so are StyleGAN2's 4-tap blurs (depthwise filters
bound by memory, read as ``blur_roofline_pct``: under 1 % of a step's
FLOPs); nothing is recomputed, so nothing is counted twice."""

from __future__ import annotations

import functools
import json
from typing import Dict

import torch

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet), in
# FLOP/s, by the precision of the step's convolutions and products.
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def step_flops(reference: Dict, kind: str) -> float:
    """FLOPs of one step of ``kind`` (``plain``, or ``r1`` with the R1
    penalty) of the configuration's ``reference`` table."""
    return _cached(json.dumps(reference, sort_keys=True), kind)


@functools.lru_cache(maxsize=None)
def _cached(reference_json: str, kind: str) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.families import make_model
    from benchmark.reference.step import Trainer

    ref = json.loads(reference_json)
    model = make_model(ref["model"])
    weights = {part: {name: torch.zeros(shape, device="meta")
                      for name, shape, _ in spec}
               for part, spec in (("generator", model.g_spec()),
                                  ("discriminator", model.d_spec()))}
    trainer = Trainer(ref, weights, 0, "meta", count_flops=True)
    rc = ref["recipe"]
    size = ref["model"]["image_size"]
    images = torch.zeros((rc["batch_size"] * rc["n_critic"], size, size, 3),
                         dtype=torch.uint8, device="meta")
    step = rc.get("d_reg_every", 1) if kind == "r1" else 1
    if kind not in trainer.kinds():
        raise ValueError(f"this recipe has no {kind} step; it has "
                         f"{trainer.kinds()}")
    with FlopCounterMode(display=False) as counter:
        trainer.step(images, step)
    return float(counter.get_total_flops())
