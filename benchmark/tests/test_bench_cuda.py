"""On the card (marker ``cuda``; each test skips without one): at each
cell's own size, the program passes its correctness check and the control,
the program in bfloat16 (``--dtype bf16``), fails it. Run on the card
with

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

from __future__ import annotations

import pytest

from conftest import ROOT

CELLS = ["sndcgan_c10_b512.train", "sg2_c10_b64.train", "sg2_afhq512_b16.train"]


def _gaps(cell_name: str, seed: int, extra=()):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.spec import load_cell
    from benchmark.harness.train import compared_gaps

    cell = load_cell(cell_name, ROOT)
    return cell.limits, compared_gaps(cell.config, cell.traffic, seed,
                                      "cuda", extra)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes(cell):
    limits, gaps = _gaps(cell, 90001)
    assert all(gaps[k] <= limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_fails(cell):
    limits, gaps = _gaps(cell, 90002, ("--dtype", "bf16"))
    assert any(gaps[k] > limits[k] for k in limits), gaps
