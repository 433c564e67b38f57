"""``harness/trace.py``: the window's trace from the profiler's events,
with the lead-in's kernels left out and times on the host clock."""

from __future__ import annotations

import pytest


def _events():
    """The lead-in's kernels (two of three kept), then the window's."""
    from benchmark.harness.trace import LEAD_IN_KERNEL, WINDOW

    ms = 1_000_000  # ns
    spin = f"void at::cuda::(anonymous namespace)::{LEAD_IN_KERNEL}(long)"
    return [
        (spin, True, 1 * ms, 2 * ms),
        (spin, True, 3 * ms, 4 * ms),
        ("cudaLaunchKernel", False, 0, 3 * ms),
        (WINDOW, False, 10 * ms, 30 * ms),
        (WINDOW, True, 10 * ms, 30 * ms),  # the annotation's mirror
        ("cudaGraphLaunch", False, 10 * ms, 11 * ms),
        ("contrad_mark_step_begin", True, 11 * ms, 12 * ms),
        ("kernel", True, 12 * ms, 20 * ms),
        ("contrad_mark_step_end", True, 20 * ms, 21 * ms),
    ]


def test_window_trace_leaves_out_the_lead_in():
    from benchmark.harness.trace import window_trace

    tr = window_trace(_events(), 0.04)  # the host clock read twice as long
    assert [k[0] for k in tr.kernels()] == [
        "contrad_mark_step_begin", "kernel", "contrad_mark_step_end"]
    assert tr.kernels()[1][1:] == pytest.approx((0.004, 0.020))
    assert [h[0] for h in tr.host] == ["benchmark.window", "cudaGraphLaunch"]
    assert tr.lead_in == 2
    assert tr.busy_s() == pytest.approx(0.020)


def test_window_trace_needs_the_annotation():
    from benchmark.harness.trace import window_trace

    with pytest.raises(RuntimeError, match="no window annotation"):
        window_trace([("kernel", True, 0, 1)], 1.0)


def test_a_window_that_lost_its_first_mark_reads_no_phases():
    """What the lead-in guards against: a window whose first step lost its
    begin mark reads no phases; the whole window reads its one step."""
    from benchmark.harness import phases
    from benchmark.harness.trace import window_trace

    ev = _events()
    lost = [e for e in ev if e[0] != "contrad_mark_step_begin"]
    assert phases.read(window_trace(lost, 0.02).kernels()) is None
    p = phases.read(window_trace(ev, 0.02).kernels())
    assert len(p.steps) == 1 and p.marks == 2


def test_a_traced_run_holds_the_window_alone():
    """A traced run on the CPU at tiny widths (no lead-in there): the
    trace holds the window's own steps, one ``contrad.step`` span each,
    and none of the set-up's."""
    from conftest import ROOT, tiny_config

    from benchmark.harness.spec import load_json
    from benchmark.harness.train import run_cell

    cfg = tiny_config("stylegan2_afhq512_b16", 4, size=8)
    cfg["program"]["argv"] += ["--d_reg_every", "2"]
    cfg["reference"]["recipe"]["d_reg_every"] = 2
    cfg["compare"] = [[1, 1], [2, 2]]
    traffic = load_json(ROOT / "benchmark" / "traffic" / "bf16.json")
    traffic.update(settle_s=0, trace={"min_steps": 1})
    limits = load_json(ROOT / "benchmark" / "limits"
                       / "sg2_afhq512_b16.bf16.json")
    rec = run_cell(cfg, traffic, limits, 424242, 0.0, True, "cpu")
    assert rec["correct"], rec["checks"]
    assert rec["window"]["kinds"] == {"plain": 5, "r1": 5}
    spans = [h for h in rec["trace"].host if h[0] == "contrad.step"]
    assert len(spans) == rec["window"]["steps"] == 10
    assert min(h[1] for h in rec["trace"].host) >= 0.0
