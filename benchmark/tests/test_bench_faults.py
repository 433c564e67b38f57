"""A run with its timed path broken underneath comes out not correct: the
whole run (build, compared steps, window, reference) on the CPU at tiny
widths, under the cell's own limits, skipping only the look for a card,
with each fault a training cell can have on one card planted, and R1 left
out where the recipe runs it."""

from __future__ import annotations

import pytest

from conftest import ROOT, tiny_config

CELLS = {"sndcgan_c10_b512.train": lambda: tiny_config("sndcgan_c10_b512", 8),
         "sg2_c10_b64.train": lambda: tiny_config("stylegan2_c10_b64", 4,
                                                  size=8)}


CASES = [(cell, fault) for cell in sorted(CELLS)
         for fault in ("frozen", "half_batch", None)]
CASES.append(("sg2_c10_b64.train", "no_r1"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault, traffic):
    from benchmark.harness.faults import FAULTS
    from benchmark.harness.spec import load_json
    from benchmark.harness.train import run_cell

    limits = load_json(ROOT / "benchmark" / "limits" / f"{cell}.json")
    rec = run_cell(CELLS[cell](), traffic, limits, 424242, 0.0, False,
                   "cpu", plant=FAULTS.get(fault))
    assert rec["correct"] is (fault is None), rec["checks"]
    assert rec["window"]["steps"] % rec["period"] == 0
