"""The evaluation's state across ``--resume`` (``contrad_tpu_torch/evaluate/
persist.py`` and the trackers of ``evaluate/fid.py`` and
``evaluate/visual.py``) against the JAX package's, in one on-disk layout:

* the committed JAX run's sidecar (``runs/r5_sg2_200k/eval_state.npz``,
  copied into a temporary directory because a restore deletes stray frame
  files) restores into the port: ``eval_seed`` 6608, the (100, 5) FID
  history, its best, embedder and size, and the 16 GIF latents;
* a sidecar the port writes (with GIF frames) restores into the JAX
  package's trackers, and one the JAX package writes into the port's;
* frames are written once each, and frames beyond the recorded count are
  removed on restore;
* ``FixedSampleGeneration``: latents from a generator seeded as asked,
  4x4 grids, and its state across a round trip."""

import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import contrad_tpu.evaluate.fid as jfid
import contrad_tpu_torch.evaluate.fid as pfid
from contrad_tpu.evaluate.persist import (
    restore_eval_state as j_restore, save_eval_state as j_save)
from contrad_tpu.evaluate.visual import (
    FixedSampleGeneration as JaxFixedGen)
from contrad_tpu.models import get_architecture as jax_get_architecture
from contrad_tpu_torch.evaluate.persist import (
    restore_eval_state, save_eval_state)
from contrad_tpu_torch.evaluate.visual import FixedSampleGeneration
from contrad_tpu_torch.models import get_architecture, generate
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "runs" / "r5_sg2_200k" / "eval_state.npz"


def _stats(tmp_path):
    d = tmp_path / "stats"
    d.mkdir(exist_ok=True)
    np.savez(d / "ds_stats.npz", mu=np.zeros(3), sigma=np.eye(3))
    return str(d)


def _port(tmp_path, n_avg=3, size=2000, volatile=False):
    G, _ = get_architecture("stylegan2_tiny", (8, 8, 3), device="cpu", seed=0)
    fid = pfid.FIDScore("ds", size=size, n_avg=n_avg, embedder="moments",
                        stats_dir=_stats(tmp_path), device="cpu")
    return fid, FixedSampleGeneration(G, 1, volatile=volatile), G


def _jax(tmp_path, n_avg=3, size=2000):
    G, _ = jax_get_architecture("stylegan2_tiny", (8, 8, 3))
    fid = jfid.FIDScore("ds", size=size, n_avg=n_avg, embedder="moments",
                        stats_dir=_stats(tmp_path))
    return fid, JaxFixedGen(G, jax.random.PRNGKey(1))


def test_the_committed_jax_sidecar_restores_into_the_port(tmp_path):
    logdir = tmp_path / "run"
    logdir.mkdir()
    shutil.copy(FIXTURE, logdir / "eval_state.npz")
    fid, gen, _ = _port(tmp_path)
    assert restore_eval_state(str(logdir), fid=fid, fixed_gen=gen) == 6608
    with np.load(FIXTURE) as d:
        assert np.array_equal(np.asarray(fid.history), d["fid_history"])
        assert fid.best == float(d["fid_best"]) and fid.best == pytest.approx(
            0.0451, abs=1e-4)
        assert np.array_equal(gen.z.numpy(), d["gif_z"])
    assert fid.history[0][0] == 2000 and len(fid.history) == 100
    assert (fid.embedder, fid.size, gen.z.shape) == ("moments", 2000,
                                                     (16, 512))
    assert gen.frames == []  # the run kept no frame files: none is invented
    assert restore_eval_state(str(tmp_path / "none")) is None


def test_the_fixture_under_another_size_or_embedder_resets_best(tmp_path):
    logdir = tmp_path / "run"
    logdir.mkdir()
    shutil.copy(FIXTURE, logdir / "eval_state.npz")
    fid, _, _ = _port(tmp_path, size=10000)
    restore_eval_state(str(logdir), fid=fid)
    assert fid.best == float("inf") and fid.history == []


def _frames(n, seed=0):
    return [np.random.default_rng(seed + i).integers(0, 256, (42, 42, 3),
                                                     dtype=np.uint8)
            for i in range(n)]


def test_a_port_sidecar_restores_into_jax(tmp_path):
    fid, gen, _ = _port(tmp_path)
    for step in (2, 4):
        fid.update(step, feature_fn=lambda n, s: np.random.default_rng(
            s + step).normal(size=(20, 3)))
    gen.frames = _frames(2)
    save_eval_state(str(tmp_path), 1234, fid=fid, fixed_gen=gen)

    j_fid, j_gen = _jax(tmp_path)
    assert j_restore(str(tmp_path), fid=j_fid, fixed_gen=j_gen) == 1234
    assert np.array_equal(np.asarray(j_fid.history), np.asarray(fid.history))
    assert j_fid.best == fid.best
    assert np.array_equal(np.asarray(j_gen.z), gen.z.numpy())
    assert len(j_gen.frames) == 2
    for a, b in zip(j_gen.frames, gen.frames):
        assert np.array_equal(a, b)


def test_a_jax_sidecar_restores_into_the_port(tmp_path):
    j_fid, j_gen = _jax(tmp_path)
    j_fid.update(3, feature_fn=lambda n, s: np.random.default_rng(s).normal(
        size=(20, 3)))
    j_gen.frames = _frames(3, seed=7)
    j_save(str(tmp_path), 42, fid=j_fid, fixed_gen=j_gen)

    fid, gen, _ = _port(tmp_path)
    assert restore_eval_state(str(tmp_path), fid=fid, fixed_gen=gen) == 42
    assert fid.history == j_fid.history and fid.best == j_fid.best
    assert np.array_equal(gen.z.numpy(), np.asarray(j_gen.z))
    assert gen.z.dtype == torch.float32
    for a, b in zip(gen.frames, j_gen.frames, strict=True):
        assert np.array_equal(a, b)


def test_frames_are_written_once_and_stale_ones_removed(tmp_path):
    fid, gen, _ = _port(tmp_path)
    gen.frames = _frames(2)
    save_eval_state(str(tmp_path), 5, fid=fid, fixed_gen=gen)
    fdir = tmp_path / "eval_gif_frames"
    first = (fdir / "000000.npy").stat().st_mtime_ns
    gen.frames.append(_frames(1, seed=9)[0])
    save_eval_state(str(tmp_path), 5, fid=fid, fixed_gen=gen)
    assert (fdir / "000000.npy").stat().st_mtime_ns == first
    assert sorted(os.listdir(fdir)) == ["000000.npy", "000001.npy",
                                        "000002.npy"]
    # a run rolled back past frames 1 and 2: the sidecar counts one
    gen.frames = gen.frames[:1]
    np.save(fdir / "000007.npy", gen.frames[0])
    sd = dict(np.load(tmp_path / "eval_state.npz"))
    sd["gif_n_frames"] = np.int64(1)
    np.savez(tmp_path / "eval_state.npz", **sd)
    _, fresh, _ = _port(tmp_path)
    restore_eval_state(str(tmp_path), fixed_gen=fresh)
    assert len(fresh.frames) == 1 and sorted(os.listdir(fdir)) == [
        "000000.npy"]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_fixed_sample_generation(tmp_path):
    _, gen, G = _port(tmp_path)
    want = G.sample_latent(16, torch.Generator().manual_seed(1))
    assert torch.equal(gen.z, want)
    rng = lambda: torch.Generator().manual_seed(3)
    frame = gen.update(lambda z: generate(G, z, noise_rng=rng()).detach())
    assert frame.shape == (4 * 10 + 2, 4 * 10 + 2, 3)
    assert frame.dtype == np.uint8 and len(gen.summary()) == 1
    sd = gen.state_dict()
    _, other, _ = _port(tmp_path)
    other.z = torch.zeros_like(other.z)
    other.load_state_dict(sd)
    assert torch.equal(other.z, gen.z) and len(other.frames) == 1
    _, volatile, _ = _port(tmp_path, volatile=True)
    assert volatile.z is None and volatile.state_dict() == {}
    assert volatile.update(lambda z: z) is None
    save_eval_state(str(tmp_path), 8, fixed_gen=volatile)
    with np.load(tmp_path / "eval_state.npz") as d:
        assert set(d.files) == {"eval_seed"}
