"""The train CLIs in a world of processes: ``python -m contrad_tpu_torch.
train_gan ... --multihost --device cpu`` as two gloo processes
(``hostenv.spawn_world``), on the flagship recipe at 16x16 (batch 8,
synthetic data, the ``moments`` FID embedder, its reference statistics in a
temporary directory).

  * Rank 0 alone writes the run directory: one directory, one FID CSV, each
    evaluation's scalars once; the log says a gloo world runs the eager
    step, and the GIF is off.
  * A world-2 checkpoint at step 2 resumed in a world of 2 to step 4 equals
    the uninterrupted world-2 run's step-4 checkpoint bitwise, and loads in
    one process (no world), which continues from it.
  * The collective FID (every rank samples its share of each chunk, the
    features gathered) is within rtol 1e-3 of the same run in one process,
    as the JAX package's ``tests/test_multihost_spawn.py:307-341`` holds
    its collective FID; the training losses agree as closely.
  * A global batch that does not divide the world, a StyleGAN2 batch whose
    minibatch-stddev groups would straddle ranks, and ``--steps_per_dispatch
    2`` in a gloo world fail with their messages.
"""

import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from contrad_tpu_torch import train_gan
from contrad_tpu_torch.hostenv import (
    free_port, rank_env, spawn_world, worker_env)
from contrad_tpu_torch.utils.checkpoint import restore_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
        "--aug", "simclr", "--use_warmup", "--device", "cpu",
        "--print_every", "1", "--evaluate_every", "2", "--fid_embed",
        "moments", "--n_eval_avg", "2"]
OVERRIDE = ["options.dataset=synthetic_16_64", "options.batch_size=8",
            "options.fid_size=32"]
# a world process: the CLI with the FID statistics in ``stats``
RUN = ("import sys; import contrad_tpu_torch.evaluate.fid as f; "
       "f.STATS_DIR = sys.argv[1]; from contrad_tpu_torch import {cli} as c; "
       "c.main(sys.argv[2:])")


def world(argv, stats, cli="train_gan", world_size=2):
    port = free_port()
    env = dict(worker_env(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-c", RUN.format(cli=cli), stats] + argv + [
        "--multihost"]
    return spawn_world([(cmd, rank_env(env, port, r, world_size))
                        for r in range(world_size)], cwd=ROOT, timeout=600)


def argv(root, steps, *extra):
    return ARGS + ["--logdir_root", root] + list(extra) + [
        "--override"] + OVERRIDE + [f"options.max_steps={steps}"]


def run_dirs(root):
    return sorted(glob.glob(os.path.join(root, "gan", "c10_b64", "sndcgan",
                                         "*", "*")))


def scalars(logdir, tag):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == tag]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs, their checkpoints (139 MiB each) removed at the end."""
    tmp = tmp_path_factory.mktemp("world_cli")
    stats = str(tmp / "stats")
    straight = str(tmp / "straight")
    outs = world(argv(straight, 4), stats)
    first = str(tmp / "first")
    world(argv(first, 2), stats)
    [logdir] = run_dirs(first)
    world(argv(first, 4, "--resume", logdir), stats)
    yield dict(tmp=tmp, stats=stats, straight=straight, first=first,
               outs=outs)
    shutil.rmtree(tmp)


def test_rank_zero_alone_writes_the_run_directory(runs):
    dirs = run_dirs(runs["straight"])
    assert len(dirs) == 1, dirs
    logdir = dirs[0]
    assert len(glob.glob(os.path.join(logdir, "results_fid_*.csv"))) == 1
    assert len(scalars(logdir, "gan/test/fid")) == 2
    assert len(scalars(logdir, "gan/train/D_loss")) == 4
    assert sorted(os.listdir(os.path.join(logdir, "ckpt"))) == [
        "best.pt", "latest.pt"]
    assert not glob.glob(os.path.join(logdir, "*.gif"))
    log = open(os.path.join(logdir, "log.txt")).read()
    assert "Multi-step dispatch: 1 step/program (a gloo world" in log
    assert "device: cpu" in log
    assert sum("in-loop GIF/aug-preview disabled" in o
               for o in runs["outs"]) == 2
    assert "[Steps       1]" not in runs["outs"][1]  # rank 1 prints no log


def test_a_world_checkpoint_resumes_bitwise_in_the_world(runs):
    [straight] = run_dirs(runs["straight"])
    [resumed] = run_dirs(runs["first"])
    log = open(os.path.join(resumed, "log.txt")).read()
    assert "Checkpoint loaded from" in log and "(step 2)" in log
    want = restore_checkpoint(straight)
    got = restore_checkpoint(resumed)
    assert got["step"] == want["step"] == 4
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_w.keys() == flat_g.keys() and len(flat_w) > 50
    for name, a in flat_w.items():
        assert torch.equal(a, flat_g[name]), name


def test_collective_fid_matches_one_process(runs, monkeypatch):
    import contrad_tpu_torch.evaluate.fid as pfid

    monkeypatch.setattr(pfid, "STATS_DIR", runs["stats"])
    torch.set_num_threads(1)
    solo = str(runs["tmp"] / "solo")
    history = train_gan.main(argv(solo, 4))
    shutil.rmtree(solo)
    [straight] = run_dirs(runs["straight"])
    fid_world = scalars(straight, "gan/test/fid")
    fid_solo = [e["fid"] for e in history.evals]
    assert len(fid_solo) == 2 and all(np.isfinite(fid_world))
    np.testing.assert_allclose(fid_world, fid_solo, rtol=1e-3)
    np.testing.assert_allclose(scalars(straight, "gan/train/D_loss"),
                               [r["D_loss"] for r in history], rtol=1e-3)


def test_a_world_checkpoint_loads_in_one_process(runs, monkeypatch):
    import contrad_tpu_torch.evaluate.fid as pfid

    monkeypatch.setattr(pfid, "STATS_DIR", runs["stats"])
    [straight] = run_dirs(runs["straight"])  # the last test to read it
    torch.set_num_threads(1)
    history = train_gan.main(ARGS + ["--resume", straight, "--no_fid",
                                     "--override"] + OVERRIDE
                             + ["options.max_steps=5"])
    assert [r["step"] for r in history] == [5]
    assert np.isfinite(history[0]["D_loss"])
    log = open(os.path.join(straight, "log.txt")).read()
    assert "Checkpoint loaded from" in log and "(step 4)" in log


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    return out


def test_a_batch_that_does_not_divide_the_world_fails(tmp_path):
    with pytest.raises(RuntimeError, match="global batch 7 must divide "
                                           "device count 2"):
        world(ARGS + ["--logdir_root", str(tmp_path), "--no_fid",
                      "--override", "options.dataset=synthetic_16_64",
                      "options.batch_size=7", "options.max_steps=1"],
              str(tmp_path))


def test_stddev_groups_across_ranks_fail(tmp_path):
    with pytest.raises(RuntimeError, match="a global batch of 4 on 2 "
                                           "processes leaves 2 rows a rank"):
        world(["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
               "--device", "cpu", "--no_fid", "--logdir_root", str(tmp_path),
               "--override", "options.dataset=synthetic_8",
               "options.batch_size=4", "options.max_steps=1"],
              str(tmp_path), cli="train_stylegan2")


def test_graph_blocks_are_refused_in_a_gloo_world(tmp_path):
    with pytest.raises(RuntimeError, match="gloo world cannot capture"):
        world(ARGS + ["--logdir_root", str(tmp_path), "--no_fid",
                      "--steps_per_dispatch", "2", "--override",
                      "options.dataset=synthetic_16_64",
                      "options.batch_size=8", "options.max_steps=2"],
              str(tmp_path))
