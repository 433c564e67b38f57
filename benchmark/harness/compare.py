"""The numbers that decide ``correct``: the program's readings of the
compared steps against the reference's, each beside its limit.

  * ``loss1_gap``: the worst relative gap of the first step's losses
    (``D_loss``, the contrastive loss; ``D_penalty``, the score head's;
    ``G_loss``; ``D_r1`` where R1 ran), all taken from the same weights,
    so that only the arithmetic's precision separates the two sides;
    ``loss1_<key>`` the gap of one of them;
  * ``loss_gap``: the same at the end of each later compared block, where
    the sign flips of small gradient elements under Adam have spread
    through the training, whatever the precision;
  * ``r1_gap``: the worst relative gap of R1's penalty at the compared
    steps where the reference ran R1;
  * ``grad_gap``: over the parameters, the worst gap between the norms of
    the first step's gradient, program against reference, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger;
  * ``proj_grad1_diff``: the first step's gradient of the last weights of
    D's contrastive projections (``projection*.fc2.weight``), together:
    the norm of the program's less the reference's over the norm of the
    reference's. They are float32 products in the program (matmuls leave
    TF32 off) over features that carry its convolutions' TF32 rounding;
    a lower precision of either shows here;
  * ``change_gap``: the gap of norms, as ``grad_gap``, of each leaf's
    change over the compared steps (G, D, and the EMA G), leaving out the
    leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by rounding alone under Adam.
A reading that is not finite, or a leaf the program lacks, reads ``inf``.
A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import math
import re
from typing import Dict

LOSSES = ("D_loss", "D_penalty", "G_loss", "D_r1")
# every number a limits file may name
NUMBERS = ("loss1_gap", "loss_gap", "r1_gap", "grad_gap", "proj_grad1_diff",
           "change_gap", "loss1_D_penalty")
PROJECTION = re.compile(r"discriminator\.projection\w*\.fc2\.weight")
STILL = 1e-3  # of the median leaf's gradient norm


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _rel(got: Dict, want: Dict, key: str) -> float:
    return _finite(abs(got.get(key, math.nan) - want[key])
                   / max(abs(want[key]), 1e-12))


def _loss_gap(prog: Dict, ref: Dict, steps, keys=LOSSES) -> float:
    worst = 0.0
    for step in steps:
        want, got = ref["losses"][step], prog["losses"].get(step, {})
        for key in keys:
            if key not in want or (key == "D_r1" and want[key] == 0.0):
                continue
            worst = max(worst, _rel(got, want, key))
    return worst


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> list:
    floor = _median(ref.values())
    return [_finite(abs(prog.get(k, math.nan) - r) / max(r, floor))
            for k, r in ref.items()]


def _diff(diff: Dict[str, float], ref: Dict[str, float], keys) -> float:
    num = sum(diff.get(k, math.nan) ** 2 for k in keys)
    return _finite(math.sqrt(num / sum(ref[k] ** 2 for k in keys)))


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    later = [s for s in ref["losses"] if s != 1]
    floor = _median(ref["grads"].values())
    moving = {k for k, g in ref["grads"].items() if g >= STILL * floor}
    change = {k: v for k, v in ref["change"].items()
              if k.replace("g_ema.", "generator.", 1) in moving}
    out = {"loss1_gap": _loss_gap(prog, ref, [1]),
           "loss_gap": _loss_gap(prog, ref, later),
           "grad_gap": max(_leaf_gaps(prog["grads"], ref["grads"])),
           "change_gap": max(_leaf_gaps(prog["change"], change)),
           "loss1_D_penalty": _rel(prog["losses"].get(1, {}),
                                   ref["losses"][1], "D_penalty")}
    proj = [k for k in ref["grads"] if PROJECTION.fullmatch(k)]
    if proj:
        out["proj_grad1_diff"] = _diff(ref["grad_diff"], ref["grads"], proj)
    r1 = [s for s in ref["losses"] if ref["losses"][s].get("D_r1", 0.0)]
    if r1:
        out["r1_gap"] = _loss_gap(prog, ref, r1, ("D_r1",))
    return out


def checks(prog: Dict, ref: Dict, limits: Dict[str, float]) -> Dict:
    """Each number ``limits`` names beside its limit; one that this run
    cannot read reads ``inf``."""
    values = gaps(prog, ref)
    return {name: {"value": values.get(name, math.inf), "limit": limit}
            for name, limit in limits.items()}
