"""Shared pieces of the benchmark's tests: the repository root on the
path, and tiny variants of the configurations for the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_config(name: str, batch: int, size: int = None, rows: int = 64,
                **model) -> dict:
    """Configuration ``name`` at ``batch`` rows (and, for StyleGAN2, the
    test-width ``stylegan2_tiny`` at ``size``), on ``rows`` images."""
    from benchmark.harness.spec import load_json

    cfg = copy.deepcopy(load_json(ROOT / "benchmark" / "configs" /
                                  f"{name}.json"))
    argv = cfg["program"]["argv"]
    if "--override" not in argv:
        argv.append("--override")
    argv[:] = [a for a in argv if not a.startswith("options.batch_size")]
    argv.insert(argv.index("--override") + 1, f"options.batch_size={batch}")
    cfg["reference"]["recipe"]["batch_size"] = batch
    cfg["data"]["rows"] = rows
    if size is not None:
        argv[1] = "stylegan2_tiny"
        argv.insert(argv.index("--override") + 1,
                    f"options.dataset=synthetic_{size}")
        m = cfg["reference"]["model"]
        m.update(image_size=size, n_mlp=2, d_hidden=32,
                 channels={str(2**i): 512 for i in range(2, size.bit_length())})
        m.update(model)
    return cfg


@pytest.fixture
def traffic():
    from benchmark.harness.spec import load_json

    return load_json(ROOT / "benchmark" / "traffic" / "train.json")
