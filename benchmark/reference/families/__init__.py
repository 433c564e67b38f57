"""Model families of the plain reference, one module each, found by name:
a configuration's ``reference.model.family`` names the module
``families/<family>.py``, whose ``MODEL`` is the family's class. Nothing
outside a family's module names the family.

A family's class takes the configuration's ``model`` table and declares
(``Family`` gives the defaults):

* ``step``: the train step it follows (``reference/step.py``'s
  ``STEPS``): ``"critic"``, ContraD's ``train_gan`` critic loop, or
  ``"ema_r1"``, its ``train_stylegan2`` step with G's EMA and the R1
  penalty at the recipe's cadence;
* ``buffers``: the name suffixes of its state entries (not trained, not
  compared; a pass may update them), e.g. spectral norm's ``.u``;
* ``g_spec()`` and ``d_spec()``: ``(name, shape, init)`` of every entry of
  G and D, by the program's ``state_dict`` names, with ``init`` one of
  ``("zeros",)``, ``("ones",)``, ``("normal", std)``, ``("trunc", std)``
  (normal clipped at two deviations, rescaled to ``std``), ``("unit",)``
  (a random unit vector), or a kind of the family's own, whose values
  ``make(name, shape, init, gen)`` makes from the generator ``gen``
  (``reference/weights.py``: a stream of its own, so that such entries
  leave the draws of the others as they are);
* ``sample_z(n, r)``: G's random inputs of a batch of ``n``, drawn from
  ``r`` (``draws.Rand``) in the program's order;
* ``generator(p, state, draws)``: NHWC images in [0, 1];
  ``discriminator(p, state, x, staged, sg_linear)``: the heads' three
  outputs (``nets.heads``); ``n_features``;
* ``blur_launches(batch)``: the blur kernel's launches in a train step
  (``counts/blur.py``'s ``Launch`` rows, forward and adjoint);
  ``fused_act_launches(batch)``: the fused activation's
  (``counts/fused_act.py``'s rows). Both are empty where the family does
  not run the kernel.
"""

from __future__ import annotations

import importlib
from typing import Dict, List


class Family:
    """Defaults of a family's declarations."""

    step = "critic"
    buffers: tuple = ()

    def make(self, name: str, shape, init, gen):
        raise ValueError(f"{type(self).__name__} makes no {init[0]!r} "
                         f"entry ({name})")

    def blur_launches(self, batch: int) -> List:
        return []

    def fused_act_launches(self, batch: int) -> List:
        return []


def make_model(cfg: Dict):
    """The family ``cfg["family"]`` of ``cfg``, a configuration's
    ``reference.model`` table."""
    family = cfg["family"]
    module = f"{__name__}.{family}"
    try:
        found = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"unknown model family {family!r}: no module "
                         f"benchmark/reference/families/{family}.py") from None
    return found.MODEL(cfg)
