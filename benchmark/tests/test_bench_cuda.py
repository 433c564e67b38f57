"""On the card (marker ``cuda``; each test skips without one): at each
cell's own size, the program passes its correctness check and the control
fails it: for a float32 mix the program in bfloat16 (``--dtype bf16``), for
the bfloat16 mix the reference with float8 products in the program's place
(``harness/train.py``'s ``control_readings``). And the program's launches
of the fused activation over a 512x512 period are the family's table. Run
on the card with

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

from __future__ import annotations

import pytest

from conftest import ROOT

CELLS = ["sndcgan_c10_b512.train", "sg2_c10_b64.train", "sg2_afhq512_b16.train",
         "sg2_afhq512_b16.bf16"]
F32_CELLS = [c for c in CELLS if not c.endswith(".bf16")]
BF16_CELLS = [c for c in CELLS if c.endswith(".bf16")]


def _cell(cell_name: str):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.spec import load_cell

    return load_cell(cell_name, ROOT)


def _gaps(cell_name: str, seed: int, extra=()):
    from benchmark.harness.train import compared_gaps

    cell = _cell(cell_name)
    return cell.limits, compared_gaps(cell.config, cell.traffic, seed,
                                      "cuda", extra)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes(cell):
    limits, gaps = _gaps(cell, 90001)
    assert all(gaps[k] <= limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", F32_CELLS)
def test_bf16_control_fails(cell):
    limits, gaps = _gaps(cell, 90002, ("--dtype", "bf16"))
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BF16_CELLS)
def test_fp8_control_fails(cell):
    from benchmark.harness.train import control_gaps

    c = _cell(cell)
    gaps = control_gaps(c.config, c.traffic, 90002, "cuda")
    assert any(gaps[k] > c.limits[k] for k in c.limits), gaps


@pytest.mark.cuda
def test_fused_act_launches_over_a_period_are_the_table():
    """``fused_leaky_relu.launches`` over one period of graph replays
    (80 steps at 512x512: 75 plain, 5 R1) against the family's table."""
    from contrad_tpu_torch.ops.fused_act import fused_leaky_relu

    from benchmark.counts.fused_act import step_launches
    from benchmark.harness.train import Program, compared_blocks

    cell = _cell("sg2_afhq512_b16.train")
    prog = Program(cell.config, cell.traffic, 90003, "cuda")
    # as a run does: the first graph block sets the runner's block size
    for block in compared_blocks(cell.config):
        prog.run_block(block)
    prog.warm()
    before = fused_leaky_relu.launches
    win = prog.window(0.0, stop_at=prog.period())
    launches = fused_leaky_relu.launches - before
    prog.close()
    model = cell.config["reference"]["model"]
    batch = cell.config["reference"]["recipe"]["batch_size"]
    assert win["kinds"] == {"plain": 75, "r1": 5}
    assert launches == sum(n * step_launches(model, batch, kind)
                           for kind, n in win["kinds"].items())
