"""The train CLIs' multi-step dispatch and trace flags (``--steps_per_dispatch``
and ``--trace_steps``, ``contrad_tpu_torch/utils/run.py::train``), on the
CPU, where a block runs its steps eagerly:

  * ``--steps_per_dispatch 0`` (auto: K = 4 for printing and evaluating
    every 4 steps) and ``1`` (the eager step) write the same
    ``scalars.jsonl`` bit for bit, at the same event steps, and the same
    final checkpoint, for ``train_gan --conditional`` and for
    ``train_stylegan2`` with lazy R1 every 2 steps (inside each block);
  * ``--resume`` at a block boundary of such a run continues it bit for
    bit (the printed metrics and every tensor of the final checkpoint);
  * ``--trace_steps 2`` writes a torch.profiler trace under
    ``<logdir>/profile/`` of the run's own first block of K = 4 steps (the
    first block boundary at or after 2 steps), with each step's phases
    (``contrad.step``, ``contrad.g``, ``contrad.d``, ``contrad.r1``,
    ``contrad.update``) spanned in order, and the loss read at its end.

``stylegan2_tiny`` runs at 16 channels a layer here (as the JAX package's
``tests/test_stylegan2.py`` block test does): its checkpoints, written at
every evaluation, take a megabyte, not 229."""

import glob
import importlib
import json
import os

import pytest

import contrad_tpu_torch.models.stylegan2.discriminator as sg2_d
import contrad_tpu_torch.models.stylegan2.generator as sg2_g
from contrad_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_port_checkpoint import assert_bitwise
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

EVENTS = ["--print_every", "4", "--evaluate_every", "4", "--no_fid",
          "--device", "cpu"]
RUNS = {
    "train_gan": ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode",
                  "contrad", "--aug", "simclr", "--use_warmup",
                  "--conditional"] + EVENTS + [
                      "--override", "options.dataset=synthetic_16_256",
                      "options.batch_size=4"],
    "train_stylegan2": ["configs/gan/stylegan2/c10_style64.toml",
                        "stylegan2_tiny", "--mode", "contrad", "--aug",
                        "simclr", "--lbd_r1", "0.1", "--d_reg_every", "2",
                        "--halflife_k", "1", "--ema_start_k", "0",
                        "--use_warmup"] + EVENTS + [
                            "--override", "options.dataset=synthetic_8_256",
                            "options.batch_size=4"],
}


@pytest.fixture(autouse=True)
def narrow_stylegan2(monkeypatch):
    for module in (sg2_g, sg2_d):
        monkeypatch.setattr(module, "stylegan2_channels",
                            lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})


def _run(cli, root, steps, *flags):
    main = importlib.import_module(f"contrad_tpu_torch.{cli}").main
    argv = RUNS[cli]
    at = argv.index("--override")
    return main(argv[:at] + list(flags) + ["--logdir_root", str(root)]
                + argv[at:] + [f"options.max_steps={steps}"])


def _read(history, name):
    with open(os.path.join(history.logdir, name)) as f:
        return f.read()


@pytest.mark.parametrize("cli", list(RUNS))
def test_auto_blocks_and_the_eager_step_write_the_same_scalars(cli,
                                                               tmp_path):
    auto = _run(cli, tmp_path / "auto", 8, "--steps_per_dispatch", "0")
    eager = _run(cli, tmp_path / "eager", 8, "--steps_per_dispatch", "1")
    assert auto.dispatch["k"] == 4 and eager.dispatch["k"] == 1
    assert "Multi-step dispatch: 4 steps/program" in _read(auto, "log.txt")
    assert "Multi-step dispatch" not in _read(eager, "log.txt")
    assert [r["step"] for r in auto] == [r["step"] for r in eager] == [4, 8]
    scalars = _read(auto, "scalars.jsonl")
    assert scalars and scalars == _read(eager, "scalars.jsonl")
    assert {json.loads(line)["step"] for line in scalars.splitlines()} == {
        4, 8}
    assert [(s["name"], s["step"]) for s in auto.saves] == [
        ("latest", 4), ("latest", 8)] == [(s["name"], s["step"])
                                          for s in eager.saves]
    assert_bitwise(restore_checkpoint(auto.logdir),
                   restore_checkpoint(eager.logdir))
    if cli == "train_stylegan2":  # the printed steps carry R1
        assert all(r["D_r1"] > 0 for r in auto)


@pytest.mark.parametrize("cli", list(RUNS))
def test_resume_at_a_block_boundary_is_bitwise(cli, tmp_path):
    straight = _run(cli, tmp_path, 8)
    first = _run(cli, tmp_path, 4)
    resumed = _run(cli, tmp_path, 8, "--resume", first.logdir)
    assert straight.dispatch["k"] == resumed.dispatch["k"] == 4
    assert [r["step"] for r in resumed] == [8]
    assert straight[1] == dict(resumed[0], seconds_per_step=straight[1][
        "seconds_per_step"])
    assert_bitwise(restore_checkpoint(straight.logdir),
                   restore_checkpoint(first.logdir))


def test_trace_steps_writes_a_trace_and_runs_the_eager_step(tmp_path):
    history = _run("train_stylegan2", tmp_path, 8, "--trace_steps", "2")
    assert history.dispatch["k"] == 4  # the run's own K, trace or none
    log = _read(history, "log.txt")
    assert f"Profiler trace written to {history.logdir}/profile" in log
    assert "Multi-step dispatch: 4 steps/program" in log
    traces = glob.glob(os.path.join(history.logdir, "profile", "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # the first block of 4 steps (a block boundary at or after 2 steps),
    # each step's phases in order, then the loss read at step 4
    spans = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("name", "").startswith("contrad.")]
    step = ["contrad.step", "contrad.update", "contrad.g", "contrad.update",
            "contrad.d", "contrad.update"]
    r1 = step[:5] + ["contrad.r1", "contrad.update"]
    kept = ("contrad.step", "contrad.d", "contrad.r1", "contrad.g",
            "contrad.update", "contrad.loop.read")
    assert [n for n in spans if n in kept] == (
        step + r1 + step + r1 + ["contrad.loop.read"])
