"""The port's quality runbook (``contrad_tpu_torch/tools/quality_run.sh``)
and its statistics step (``contrad_tpu_torch/tools/precalc_stats.py``):

* the runbook's weights-free dry run as ``tests/test_quality_run.py``
  drives JAX's (``synthetic_16``, ``moments``, 4 steps at batch 8), on the
  CPU, within 300 s: the FID trajectory's best is finite and the
  statistics are cached under the embedder's directory;
* ``precalc_stats --images`` against the JAX package's
  ``compute_stats_from_images`` on the same PNGs, with the ``moments``
  embedder and with the InceptionV3 on random weights from a numpy seed
  (``tests/test_torch_port_inception.py``'s) read from a checkpoint file
  by both packages: rtol 1e-4 / atol 1e-6 (moments) and the Inception
  parity tolerance rtol 1e-3 / atol 1e-4;
* ``precalc_stats --dataset`` writing under ``<STATS_DIR>/<embed>/``, or
  to ``--out`` capped by ``--size``;
* ``EMBED=inception`` without the weights: the asset check names the
  missing files and exits 1 before any stage that could fetch them.
"""

import math
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from contrad_tpu.evaluate.fid import compute_stats_from_images as jax_stats
from contrad_tpu.evaluate.fid import moments_embed_fn as jax_moments
from contrad_tpu.evaluate.inception import get_inception_embed_fn
from contrad_tpu_torch.evaluate import fid as pfid
from contrad_tpu_torch.tools import precalc_stats
from test_torch_port_inception import random_state
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
RUNBOOK = "contrad_tpu_torch/tools/quality_run.sh"


def _env(tmp_path, **extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update({"FID_STATS_DIR": str(tmp_path / "stats"),
                "LOGROOT": str(tmp_path / "logs"), "DEVICE": "cpu",
                "OMP_NUM_THREADS": "2"}, **extra)
    return env


def test_quality_run_dry(tmp_path):
    env = _env(tmp_path, DATASET="synthetic_16", EMBED="moments", STEPS="4",
               EVAL_EVERY="4", FID_SIZE="16",
               EXTRA_FLAGS="--no_gif --n_eval_avg 1 --print_every 2",
               EXTRA_OVERRIDES="options.batch_size=8")
    r = subprocess.run(["bash", RUNBOOK], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for stage in ("[1/5]", "[2/5]", "[3/5]", "[4/5]"):
        assert f"== {stage}" in r.stdout
    assert "[5/5]" not in r.stdout  # the cross-check needs real weights
    best = float(r.stdout.rsplit("BEST FID@16 (moments embedder):",
                                 1)[1].strip())
    assert math.isfinite(best) and best >= 0
    assert (tmp_path / "stats" / "moments" / "synthetic_16_stats.npz").is_file()
    assert not (tmp_path / "stats" / "synthetic_16_stats.npz").exists()


def test_quality_run_without_the_inception_weights_stops(tmp_path):
    env = _env(tmp_path, DATASET="cifar10", EMBED="inception",
               DATA_DIR=str(tmp_path / "data"),
               INCEPTION_WEIGHTS=str(tmp_path / "none.pth"))
    r = subprocess.run(["bash", RUNBOOK], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 1, r.stdout + r.stderr
    assert str(tmp_path / "none.pth") in r.stdout
    assert str(tmp_path / "data" / "cifar-10-batches-py") in r.stdout
    assert "[2/5]" not in r.stdout and not (tmp_path / "logs").exists()


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pngs")
    images = np.random.default_rng(0).integers(0, 256, (5, 16, 16, 3),
                                               dtype=np.uint8)
    (root / "sub").mkdir()
    for i, im in enumerate(images):  # one in a subdirectory: walked too
        Image.fromarray(im).save(root / ("sub" if i == 2 else ".")
                                 / f"{i:03d}.png")
    return root, images


@pytest.mark.parametrize("embed", ["moments", "inception"])
def test_precalc_images_matches_jax(png_dir, tmp_path, monkeypatch, embed):
    root, _ = png_dir
    jax_embed = jax_moments
    tol = dict(rtol=1e-4, atol=1e-6)
    if embed == "inception":
        weights = tmp_path / "inception.pth"
        torch.save({k: torch.from_numpy(v) for k, v in
                    random_state().items()}, weights)
        monkeypatch.setenv("INCEPTION_WEIGHTS", str(weights))
        jax_embed = get_inception_embed_fn(str(weights))
        tol = dict(rtol=1e-3, atol=1e-4)
    out = tmp_path / "stats.npz"
    path = precalc_stats.main(["--images", str(root), "--out", str(out),
                               "--embed", embed, "--batch_size", "2",
                               "--device", "cpu"])
    assert path == str(out)
    got = np.load(out)
    from contrad_tpu.data.folder import _list_images
    from PIL import Image

    files = _list_images(str(root))
    assert len(files) == 5
    images = np.stack([np.asarray(Image.open(f).convert("RGB"))
                       for f in files])
    mu, sigma = jax_stats(images, jax_embed, 2)
    np.testing.assert_allclose(got["mu"], mu, **tol)
    np.testing.assert_allclose(got["sigma"], sigma, **tol)


def test_precalc_images_size_and_default_path(png_dir):
    root, _ = png_dir
    path = precalc_stats.main(["--images", str(root), "--size", "3",
                               "--embed", "moments", "--device", "cpu"])
    assert path == str(root) + "_stats.npz"
    from contrad_tpu_torch.tools.precalc_stats import read_images

    mu, sigma = pfid.compute_stats_from_images(read_images(str(root), 3),
                                               pfid.moments_embed_fn)
    got = np.load(path)
    np.testing.assert_array_equal(got["mu"], mu)
    np.testing.assert_array_equal(got["sigma"], sigma)


def test_precalc_dataset_writes_under_the_embedders_directory(
        tmp_path, monkeypatch):
    monkeypatch.setattr(pfid, "STATS_DIR", str(tmp_path))
    path = precalc_stats.main(["--dataset", "synthetic_8_64", "--embed",
                               "moments", "--device", "cpu"])
    assert path == str(tmp_path / "moments" / "synthetic_8_64_stats.npz")
    from contrad_tpu_torch.data import get_dataset_ref

    ref = get_dataset_ref("synthetic_8_64").images
    mu, sigma = jax_stats(np.asarray(ref), jax_moments, 50)
    np.testing.assert_allclose(np.load(path)["mu"], mu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.load(path)["sigma"], sigma, rtol=1e-4,
                               atol=1e-6)
    out = tmp_path / "capped.npz"
    precalc_stats.main(["--dataset", "synthetic_8_64", "--out", str(out),
                        "--size", "100", "--embed", "moments",
                        "--device", "cpu"])
    mu, _ = jax_stats(np.asarray(ref[:100]), jax_moments, 50)
    np.testing.assert_allclose(np.load(out)["mu"], mu, rtol=1e-4, atol=1e-6)
