#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card(s) of this machine:

    python3 benchmark/run.py --workload sndcgan_c10_b512.train --seed 7 \\
        --seconds 30 --trace 0

prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those whose printed
losses were not finite), ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
``{"value", "unit"}``), ``device`` (and with ``--trace 1`` ``breakdown``)
and last ``checks``: each number the correctness check compared, beside
its limit. The same numbers close standard error. It exits with 2 and no
result where the machine has fewer cards than the cell asks for, and with
1 where the run fails or JAX (or the JAX package) was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def result(cell, rec: dict, trace: bool, kind: str, power: str) -> dict:
    """The result line of run record ``rec`` on ``kind`` cards."""
    win = rec["window"]
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": rec["memory_peak_bytes"],
              "power_limit": power}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"]}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = {"train_img_s": rec["batch"] * win["steps"] / win["seconds"],
                  "peak_mem_gib": rec["memory_peak_bytes"] / 2**30,
                  "setup_s": rec["setup_s"]}
        metrics = {m["name"]: metric(values[m["name"]], units[m["name"]])
                   for m in cell.end_to_end}
    else:
        run = {"trace": rec["trace"], "window_s": rec["window_s"],
               "steps": win["steps"], "kinds": win["kinds"],
               "capture_s": rec["capture_s"],
               "counters": rec["counters"],
               "config": cell.config, "dtype": cell.traffic["dtype"]}
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](run)
            if value is not None:
                metrics[m["name"]] = metric(value, m["unit"])
        device["busy_s"] = rec["trace"].busy_s()
        device["window_s"] = rec["window_s"]
    out["metrics"] = metrics
    out["device"] = device
    if trace:
        out["breakdown"] = rec["trace"].breakdown()
    out["checks"] = {name: {k: (v if math.isfinite(v) else repr(v))
                            for k, v in c.items()}
                     for name, c in rec["checks"].items()}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    # every build and kernel cache at a fixed path inside the checkout (the
    # port builds its CUDA kernels into contrad_tpu_torch/_build/ itself)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    from benchmark.harness.spec import forbidden_modules, load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.harness.train import run_cell

    rec = run_cell(cell.config, cell.traffic, cell.limits, args.seed,
                   args.seconds, bool(args.trace), "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 1
    line = result(cell, rec, bool(args.trace), torch.cuda.get_device_name(0),
                  power_limit())
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
