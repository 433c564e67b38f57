"""The worker's SNDCGAN recipes (``contrad_tpu_torch/parallel/_mh_worker.py``:
the ``contrad`` default and ``--conditional``, at the JAX worker's widths)
as a 2-process gloo world on the CPU against the same recipe in one
process, in float64, three steps with Adam and warmup, the port drawing
its own draws and reading its batches through the sharded loader (16x16,
global batch 8). The StyleGAN2 trainer's world is held to one process on the
CPU by ``tests/test_torch_port_world.py`` (SGD, 16 channels a layer: the
registry's smallest StyleGAN2 holds 17 M parameters, too many to write
three float64 states of per run here) and with Adam on the card
(``chip_smoke.py`` phase 12b).

  * Every tensor of the trainer state is bitwise equal across the two ranks:
    parameters, spectral norm's ``u``, batch-norm statistics, EMA G, Adam's
    moments and counts, and the generator's state (the draws of the global
    step on every rank keep the generators equal); the first step's
    gradients after the all-reduce and every step's metrics too.
  * The world of 2 is within 1e-6 of the one process (relative to each
    tensor's largest magnitude, with an absolute floor of 1e-12 for float64
    rounding noise, ``tests/test_torch_port_world.py``), the generator's
    state and the counts exactly.
"""

import os
import sys

import pytest
import torch

from contrad_tpu_torch.hostenv import free_port, spawn_world, worker_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "sndcgan": [],
    "conditional": ["--conditional"],
}


def _run(tmp, name, world):
    out = str(tmp / f"{name}_w{world}")
    env = dict(worker_env(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "contrad_tpu_torch.parallel._mh_worker",
           "--device", "cpu", "--dtype", "f64", "--steps", "3", "--batch",
           "8", "--out", out, "--world", str(world)] + RECIPES[name]
    port = free_port()
    spawn_world([(cmd + ["--rank", str(r), "--port", str(port)], env)
                 for r in range(world)], cwd=ROOT, timeout=600)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module", params=list(RECIPES))
def recipe(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recipes")
    return request.param, _run(tmp, request.param, 2), _run(
        tmp, request.param, 1)[0]


def test_replicas_are_bitwise_equal_across_ranks(recipe):
    name, (a, b), _ = recipe
    assert a["metrics"] == b["metrics"]
    assert a["state"].keys() == b["state"].keys()
    assert any("rng" in k for k in a["state"])
    assert any("mu" in k for k in a["state"]) or any(
        "optimizer" in k for k in a["state"])
    for key, v in a["state"].items():
        assert torch.equal(v, b["state"][key]), key
    for which in ("g_grads", "d_grads"):
        for x, y in zip(a[which][0], b[which][0], strict=True):
            assert torch.equal(x, y), which


def _close(got, want, what):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= 1e-6 * scale + 1e-12, f"{what}: {err:.3g} (scale {scale:.3g})"


def test_world_of_two_matches_one_process(recipe):
    _, (got, _), want = recipe
    for m_got, m_want in zip(got["metrics"], want["metrics"], strict=True):
        for k in m_want:
            _close(torch.tensor(m_got[k]), torch.tensor(m_want[k]), k)
    assert got["state"].keys() == want["state"].keys()
    for key, v in want["state"].items():
        if v.is_floating_point():
            _close(got["state"][key], v, key)
        else:
            assert torch.equal(got["state"][key], v), key
    for which in ("g_grads", "d_grads"):
        for x, y in zip(got[which][0], want[which][0], strict=True):
            _close(x, y, which)
