"""The port's train and evaluation CLIs end to end on the CPU (port only):
``train_gan --conditional`` on ``synthetic_16_256`` (SNDCGAN at full width,
batch 8, 4 steps, ``--evaluate_every 2 --save_every 4``), ``--resume`` to
step 6, ``test_lineval`` for one epoch, ``test_gan_sample`` and
``test_gan_sample_cddls`` for 2 steps; and ``train_stylegan2`` at the
``stylegan2_tiny`` width (8x8, 2 steps) sampled with ``--use_ema``.
Checked against the JAX CLIs' layout: the run directory
(``gan/<config stem>/<arch>/<run name>/<rand>/`` with ``config.toml``,
``log.txt``, ``scalars.jsonl`` under the ``gan/train/*`` tags, ``ckpt/``),
the probe's CSV header (read from the JAX CLI's source) and its ``.npz``,
the ``samples_<rand>_n<N>/<i>.png`` and ``samples_cDDLS_<rand>/<y>/<i>.png``
files, the images' shape, and that evaluation CLIs refuse a missing
checkpoint and another architecture than the run's."""

import glob
import json
import os
import re
import tomllib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
GAN = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
       "--aug", "simclr", "--use_warmup", "--conditional", "--device", "cpu",
       "--print_every", "1", "--evaluate_every", "2", "--save_every", "4",
       "--override", "options.dataset=synthetic_16_256",
       "options.batch_size=8"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from contrad_tpu_torch import train_gan

    root = str(tmp_path_factory.mktemp("logs"))
    first = train_gan.main(GAN + ["options.max_steps=4", "--logdir_root",
                                  root])
    resumed = train_gan.main(GAN + ["options.max_steps=6", "--resume",
                                    first.logdir, "--logdir_root", root])
    return root, first, resumed


def test_run_directory_is_the_jax_clis(run):
    root, first, resumed = run
    rel = os.path.relpath(first.logdir, root).split(os.sep)
    assert rel[:4] == ["gan", "c10_b64", "sndcgan",
                       "contrad_simclr_L1.0_T0.1"] and rel[4].isdigit()
    assert resumed.logdir == first.logdir
    assert [r["step"] for r in resumed] == [5, 6]
    assert sorted(os.listdir(os.path.join(first.logdir, "ckpt"))) == [
        "latest.pt", "step_4.pt"]
    cfg = tomllib.loads(open(os.path.join(first.logdir, "config.toml")).read())
    assert cfg["options"]["dataset"] == "synthetic_16_256"  # the override
    assert cfg["options"]["batch_size"] == 8
    tags = {}
    for line in open(os.path.join(first.logdir, "scalars.jsonl")):
        rec = json.loads(line)
        tags.setdefault(rec["tag"], []).append(rec["step"])
    assert tags["gan/train/G_loss"] == [1, 2, 3, 4, 5, 6]
    assert set(tags) == {f"gan/train/{k}" for k in (
        "D_loss", "D_penalty", "D_real", "D_gen", "G_loss")}
    log = open(os.path.join(first.logdir, "log.txt")).read()
    assert re.search(r"^\[\d{4}-\d\d-\d\d .*\] \[Steps       6\]", log, re.M)
    assert "Checkpoint loaded from" in log and "step 4)" in log


def test_probe_sample_and_cddls_on_the_run(run):
    from contrad_tpu_torch import test_gan_sample, test_gan_sample_cddls
    from contrad_tpu_torch import test_lineval

    _, first, _ = run
    logdir = first.logdir
    probe = test_lineval.main([logdir, "sndcgan", "--epochs", "1",
                               "--batch_size", "64", "--device", "cpu"])
    jax_cli = (ROOT / "test_lineval.py").read_text()
    header = open(probe["csv"]).readline()
    assert header == test_lineval.CSV_HEADER
    assert header.strip() in jax_cli
    rows = open(probe["csv"]).read().splitlines()[1:]
    assert len(rows) == 1 and rows[0].startswith("0,")
    rec = probe["epochs"][0]
    assert rec["lr"] == 0.1 and 0 <= rec["test_acc"] <= 100
    weights = np.load(probe["npz"])
    assert weights["w"].shape == (8 * 64 * 2 * 2, 10)
    assert weights["b"].shape == (10,)

    subdir = test_gan_sample.main([logdir, "sndcgan", "--n_samples", "5",
                                   "--batch_size", "2", "--device", "cpu"])
    assert re.fullmatch(r"samples_\d+_n5", os.path.basename(subdir))
    assert sorted(os.listdir(subdir)) == [f"{i}.png" for i in range(5)]
    assert np.asarray(Image.open(os.path.join(subdir, "0.png"))).shape == (
        16, 16, 3)

    out = test_gan_sample_cddls.main([
        logdir, probe["npz"], "sndcgan", "--n_steps", "2", "--n_samples", "7",
        "--n_classes", "3", "--batch_size", "2", "--device", "cpu"])
    assert re.fullmatch(r"samples_cDDLS_\d+", os.path.basename(out["subdir"]))
    assert sorted(os.listdir(out["subdir"])) == ["0", "1", "2"]
    for y in range(3):  # n_samples // n_classes a class, numbered on
        files = os.listdir(os.path.join(out["subdir"], str(y)))
        assert sorted(files) == sorted(f"{y * 2 + j}.png" for j in range(2))
    assert out["samples"] == 6 and out["chains"] == 3
    with pytest.raises(FileNotFoundError, match="step_9"):
        test_gan_sample.main([logdir, "sndcgan", "--ckpt", "step_9",
                              "--device", "cpu"])
    with pytest.raises(ValueError, match="trained sndcgan"):
        test_gan_sample.main([logdir, "snresnet18", "--device", "cpu"])


def test_stylegan2_run_samples_from_its_ema(tmp_path):
    from contrad_tpu_torch import test_gan_sample, train_stylegan2

    history = train_stylegan2.main([
        "configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
        "--no_lazy", "--lbd_r1", "0.1", "--device", "cpu", "--print_every",
        "1", "--evaluate_every", "2", "--logdir_root", str(tmp_path),
        "--override", "options.dataset=synthetic_8_256",
        "options.batch_size=4", "options.max_steps=2"])
    rel = os.path.relpath(history.logdir, tmp_path).split(os.sep)
    assert rel[:3] == ["gan_dp", "st_c10_style64", "stylegan2_tiny"]
    assert rel[3].endswith("_R0.1_mix0.9_H20_NoLazy")
    subdir = test_gan_sample.main([history.logdir, "stylegan2_tiny",
                                   "--n_samples", "3", "--batch_size", "4",
                                   "--use_ema", "--device", "cpu"])
    assert len(glob.glob(os.path.join(subdir, "*.png"))) == 3
