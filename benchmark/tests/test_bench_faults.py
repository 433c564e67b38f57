"""A run with its timed path broken underneath comes out not correct: the
whole run (build, compared steps, window, reference) on the CPU at tiny
widths, under the cell's own limits, skipping only the look for a card,
with each fault a training cell can have on one card planted, and R1 left
out where the recipe runs it; the bfloat16 cell in its own mix."""

from __future__ import annotations

import pytest

from conftest import ROOT, tiny_config

def _lazy_r1(cfg):
    """The 512x512 recipe's lazy R1 at every second step, so that a short
    run holds both kinds of step."""
    cfg["program"]["argv"] += ["--d_reg_every", "2"]
    cfg["reference"]["recipe"]["d_reg_every"] = 2
    cfg["compare"] = [[1, 1], [2, 2]]
    return cfg


# cell -> (a tiny configuration, its traffic mix)
CELLS = {"sndcgan_c10_b512.train": (lambda: tiny_config("sndcgan_c10_b512", 8),
                                    "train"),
         "sg2_c10_b64.train": (lambda: tiny_config("stylegan2_c10_b64", 4,
                                                   size=8), "train"),
         "sg2_afhq512_b16.bf16": (lambda: _lazy_r1(tiny_config(
             "stylegan2_afhq512_b16", 4, size=8)), "bf16")}


CASES = [(cell, fault) for cell in sorted(CELLS)
         for fault in ("frozen", "half_batch", None)]
CASES += [(cell, "no_r1") for cell in ("sg2_afhq512_b16.bf16",
                                       "sg2_c10_b64.train")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault):
    from benchmark.harness.faults import FAULTS
    from benchmark.harness.spec import load_json
    from benchmark.harness.train import run_cell

    config, mix = CELLS[cell]
    limits = load_json(ROOT / "benchmark" / "limits" / f"{cell}.json")
    traffic = load_json(ROOT / "benchmark" / "traffic" / f"{mix}.json")
    rec = run_cell(config(), traffic, limits, 424242, 0.0, False,
                   "cpu", plant=FAULTS.get(fault))
    assert rec["correct"] is (fault is None), rec["checks"]
    assert rec["window"]["steps"] % rec["period"] == 0
