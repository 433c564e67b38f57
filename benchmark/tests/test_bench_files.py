"""The harness is driven by data: every cell of ``BENCHMARK.json`` loads
with its configuration, mix, limits and readers, and a cell, a
configuration, a mix and a metric added as files in a copy are found with
no edit to a file that is there."""

from __future__ import annotations

import json
import shutil

import pytest

from conftest import ROOT


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads(cell):
    from benchmark.harness.spec import load_cell

    c = load_cell(cell, ROOT)
    assert {m["name"] for m in c.end_to_end} == {
        "train_img_s", "peak_mem_gib", "setup_s"}
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    blur = {"blur_launches_per_step", "blur_roofline_pct"}
    assert bool(blur & set(c.readers)) == cell.startswith("sg2_")
    for key in ("program", "data", "compare", "reference"):
        assert key in c.config
    from benchmark.harness.compare import NUMBERS

    assert c.limits and set(c.limits) <= set(NUMBERS)


def test_files_added_in_a_copy_are_found(tmp_path):
    from benchmark.harness.spec import load_cell

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "sndcgan_c10_b512.json").read_text())
    cfg["name"] = "sndcgan_c10_b256"
    (b / "configs" / "sndcgan_c10_b256.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "train.json").read_text())
    traffic["argv"] = traffic["argv"] + ["--dtype", "bf16"]
    traffic["dtype"] = "bf16"
    (b / "traffic" / "train_bf16.json").write_text(json.dumps(traffic))
    (b / "limits" / "sndcgan_c10_b256.bf16.json").write_text(
        (b / "limits" / "sndcgan_c10_b512.train.json").read_text())
    (b / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="sndcgan_c10_b256",
                                 file="benchmark/configs/sndcgan_c10_b256.json"))
    bench["workloads"].append({"name": "sndcgan_c10_b256.bf16",
                               "config": "sndcgan_c10_b256",
                               "traffic": "train_bf16", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "train_img_s",
                               "workloads": ["sndcgan_c10_b256.bf16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("sndcgan_c10_b256.bf16", root)
    assert cell.config["name"] == "sndcgan_c10_b256"
    assert cell.traffic["dtype"] == "bf16"
    assert cell.readers["steps_in_window"]({"steps": 7}) == 7
    assert "steps_in_window" not in load_cell("sndcgan_c10_b512.train",
                                              root).readers
    for path, data in before.items():  # nothing that was there changed
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path


def test_the_bf16_cell_loads_and_takes_the_bf16_peak():
    """``sg2_afhq512_b16.bf16``: the 512x512 configuration under the bf16
    mix, with the blur's and the fused activation's metrics, and its step
    MFU at the bf16 peak (989 TFLOP/s) where the train mix's takes TF32's
    (495)."""
    from benchmark.harness.spec import load_cell

    cell = load_cell("sg2_afhq512_b16.bf16", ROOT)
    train = load_cell("sg2_afhq512_b16.train", ROOT)
    assert cell.config == train.config and cell.chips == 1
    argv = cell.traffic["argv"]
    for flag in ("--dtype", "--opt_moments", "--opt_nu", "--opt_grads"):
        assert argv[argv.index(flag) + 1] == "bf16"
    assert cell.traffic["dtype"] == "bf16"
    assert {"r1_step_ms", "blur_roofline_pct", "fused_act_roofline_pct",
            "fused_act_launches_per_step"} <= set(cell.readers)
    # its replays do not keep the marks inside a step in place (PERF.md)
    assert not {"g_phase_ms_per_step", "d_phase_ms_per_step",
                "aug_ms_per_step", "update_ms_per_step"} & set(cell.readers)
    run = {"config": cell.config, "kinds": {"plain": 75, "r1": 5},
           "window_s": 10.0}
    bf16 = cell.readers["step_mfu_pct"](dict(run, dtype=cell.traffic["dtype"]))
    f32 = train.readers["step_mfu_pct"](dict(run,
                                             dtype=train.traffic["dtype"]))
    assert bf16 == pytest.approx(f32 * 495 / 989)
