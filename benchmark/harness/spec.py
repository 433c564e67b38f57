"""What a run is made of, found by name: the cell in ``BENCHMARK.json``,
its configuration (``benchmark/configs/<name>.json``), its traffic mix
(``benchmark/traffic/<name>.json``), the limits of its correctness check
(``benchmark/limits/<cell>.json``) and a reader for each per-layer metric
(``benchmark/metrics/<name>.py``, a function ``read(run)``). A new cell,
configuration, mix or metric is a new file and a new entry; nothing here
names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]

# top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "contrad_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, end_to_end: List[dict]) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    where it has one; else every cell that reports the end-to-end metric it
    moves (end-to-end metrics: every cell, or their own list)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = [m for m in end_to_end if m["name"] == metric["moves"]]
        return bool(moved) and applies(moved[0], cell, end_to_end)
    return True


def load_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name, bench["end_to_end"])]
    base = root / "benchmark"
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(root / conf["file"]),
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer,
                readers={m["name"]: load_reader(m["name"], root)
                         for m in per_layer})


def forbidden_modules(modules: Optional[Dict] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules, each name
    compared whole (``contrad_tpu_torch`` is not ``contrad_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in names if n in FORBIDDEN)
