#!/usr/bin/env python3
"""The readings that the limits of ``benchmark/limits/<cell>.json`` are
set from: the compared steps' gaps of the program over many seeds, of the
control (``harness/train.py``'s ``control_readings``: for a float32 mix
the program in bfloat16, ``--dtype bf16``; for a bfloat16 mix the
reference with float8 products in the program's place) and of planted
faults, all in one process, one JSON line each:

    python3 benchmark/tools/readings.py --workload sndcgan_c10_b512.train \\
        --seeds 101-112 --control 3 --faults half_batch:3,no_r1:3

The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def seeds(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="101-112")
    p.add_argument("--control", type=int, default=3,
                   help="seeds (the first of --seeds) of the control")
    p.add_argument("--faults", default="",
                   help="comma-separated name:seeds of faults to plant")
    p.add_argument("--device", default="cuda")
    p.add_argument("--detail", action="store_true",
                   help="also print both sides' losses and leaf norms")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.faults import FAULTS
    from benchmark.harness.spec import load_cell
    from benchmark.harness.compare import gaps as gaps_of
    from benchmark.harness.train import compared_readings, control_readings

    cell = load_cell(args.workload, ROOT)
    all_seeds = seeds(args.seeds)
    control = "control_bf16" if cell.traffic["dtype"] == "f32" \
        else "control_fp8"
    runs = [("program", s, None) for s in all_seeds]
    runs += [(control, s, None) for s in all_seeds[:args.control]]
    for item in filter(None, args.faults.split(",")):
        name, _, n = item.partition(":")
        runs += [(name, s, FAULTS[name]) for s in all_seeds[:int(n or 3)]]
    for variant, seed, plant in runs:
        t0 = time.perf_counter()
        detail = None
        try:
            if variant == control:
                prog, ref = control_readings(cell.config, cell.traffic, seed,
                                             args.device)
            else:
                prog, ref = compared_readings(cell.config, cell.traffic,
                                              seed, args.device, (), plant)
            gaps, error = gaps_of(prog, ref), None
            if args.detail:
                detail = {"program": prog, "reference": ref}
        except Exception as e:  # a control that fails reads as failed
            gaps, error = {}, f"{type(e).__name__}: {e}"
        print(json.dumps({"workload": args.workload, "variant": variant,
                          "seed": seed, "gaps": gaps, "error": error,
                          "seconds": time.perf_counter() - t0,
                          "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
