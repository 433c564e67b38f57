"""The result line and the guard against JAX: the line's keys, units and
order (``checks`` last), the traced line's device times and breakdown, and
forbidden modules found by whole top-level names."""

from __future__ import annotations

import ast
import json

import pytest

from conftest import ROOT


def _record(trace: bool):
    from benchmark.harness.trace import Trace

    tr = Trace(1.0, [("k_conv_fprop", 0.0, 0.4), ("blur2d_kernel", 0.35, 0.5),
                     ("void bias_act_planes_elementwise_kernel<float, 4, "
                      "true>(float const*)", 0.1, 0.12),
                     ("void bias_grad_sum_kernel<float>(float const*)", 0.12,
                      0.13),
                     ("Memcpy HtoD", 0.6, 0.7)],
               [("cudaGraphLaunch", 0.55, 0.8)])
    rec = {"window": {"steps": 20, "seconds": 2.0, "kinds": {"r1": 20}},
           "memory_peak_bytes": 2**30, "setup_s": 12.5, "batch": 64,
           "attempted": 20, "failed": 0, "correct": True, "capture_s": 0.5,
           "window_s": 1.0,
           "counters": {"blur2d.launches": 1080,
                        "fused_leaky_relu.launches": 3300,
                        "fused_leaky_relu.scalar_launches": 0},
           "checks": {"loss_gap": {"value": 1e-3, "limit": 1e-2},
                      "grad_gap": {"value": float("inf"), "limit": 1e-1}}}
    if trace:
        rec["trace"] = tr
    return rec


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    from benchmark.harness.spec import load_cell
    from benchmark.run import result

    cell = load_cell("sg2_c10_b64.train", ROOT)
    line = result(cell, _record(trace), trace, "NVIDIA H100 80GB HBM3",
                  "700.00 W")
    text = json.dumps(line)
    assert "Infinity" not in text
    keys = list(json.loads(text))
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    if not trace:
        assert line["metrics"]["train_img_s"] == {"value": 640.0,
                                                  "unit": "img/s"}
        assert set(line["metrics"]) == {"train_img_s", "peak_mem_gib",
                                        "setup_s"}
        return
    d = line["device"]
    assert d["busy_s"] == pytest.approx(0.6) and d["window_s"] == 1.0
    m = line["metrics"]
    assert m["device_idle_pct"]["value"] == pytest.approx(40.0)
    assert m["launches_per_step"]["value"] == pytest.approx(4 / 20)
    assert m["blur_launches_per_step"]["value"] == 54.0
    assert m["fused_act_launches_per_step"]["value"] == 165.0
    # 20 R1 steps of the 32x32 table's bytes over the two kernels' 0.03 s
    from benchmark.counts.fused_act import step_bytes

    ref = cell.config["reference"]
    want = 100.0 * 20 * step_bytes(ref["model"], 64, "r1") / 3.35e12 / 0.03
    assert m["fused_act_roofline_pct"]["value"] == pytest.approx(want)
    assert 0 < m["step_mfu_pct"]["value"]
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert line["breakdown"]["idle_gaps"][0][1] == pytest.approx(0.3)


def test_guard_compares_whole_names():
    from benchmark.harness.spec import forbidden_modules

    ok = {"contrad_tpu_torch": 0, "contrad_tpu_torch.models": 0,
          "jaxtyping": 0, "torch": 0}
    assert forbidden_modules(ok) == []
    bad = dict(ok, **{"contrad_tpu.models": 0, "jaxlib.xla": 0, "flax": 0})
    assert forbidden_modules(bad) == ["contrad_tpu", "flax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_the_reference_no_program():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "contrad_tpu"}, path
        if "reference" in path.parts or "counts" in path.parts:
            assert "contrad_tpu_torch" not in names, path
