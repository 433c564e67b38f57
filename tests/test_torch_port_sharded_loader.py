"""The port's sharded data path (``contrad_tpu_torch/data/core.py::
ShardedDeviceBatchIterator`` and ``parallel/collectives.py::ring_shift_``)
in a 2-process gloo world on the CPU, against the JAX package's
``ShardedDeviceBatchIterator`` on a 2-device mesh with the same numpy set:
rank r is JAX device r. Exact throughout (uint8 images, int64 labels,
integer index vectors).

One world of two (``hostenv.spawn_world`` running this file as a script)
records, on each rank:

  * 3 epochs of the stream (2 rotations): each step's index vector, labels
    and gathered images, ``steps_until_rotation`` before it, the whole
    shard and its storage's address;
  * a fresh stream resumed at epoch 3 (``load_state_dict``: the rotations
    replayed) and one resumed mid-epoch from the live stream's state;
  * at ``n_critic = 2`` each critic sub-batch of the world (every rank's
    part, gathered in rank order): JAX's rows, grouped the port's way;
  * ``ring_shift_`` of a tensor holding the rank.

A second world runs the worker's conditional SNDCGAN recipe (float64,
``--n_critic 2``) on a set the loader must shard (``--max_bytes``), against
world 1 fed the same global batches (``--feed_world 2``): replicas bitwise,
the world within 1e-6 of world 1 (relative to each tensor's largest
magnitude, with a floor of 1e-12), as ``tests/test_torch_port_world_
recipes.py`` holds the device-resident path; each batch bitwise the rows
the stream names and each shard its chunk after the rotation.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from contrad_tpu_torch.hostenv import (  # noqa: E402
    free_port, rank_env, spawn_world, worker_env)

WORLD = 2
N, SIZE, BATCH, SEED = 37, (2, 2, 3), 8, 5  # 36 rows kept: shards of 18
STEPS = 12  # 4 steps an epoch (local batch 4): 3 epochs


def _dataset():
    from contrad_tpu_torch.data import ArrayDataset

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(N,) + SIZE, dtype=np.uint8)
    images[:, 0, 0, 0] = np.arange(N)  # the row, readable in the image
    return ArrayDataset(images, rng.integers(0, 10, size=N), n_classes=10)


def _record(it, steps):
    rows = []
    for _ in range(steps):
        left = it.steps_until_rotation()
        idx, labels = it.next_indices()
        rows.append(dict(left=left, idx=idx, labels=labels, epoch=it.epoch,
                         images=it.materialize(idx).numpy(),
                         shard=it.images.numpy().copy(),
                         storage=it.images.data_ptr()))
    return rows


def world_checks(rank: int, out: str) -> None:
    """Every check that needs the world, as rank ``rank``; results to
    ``out``."""
    from contrad_tpu_torch.data import ShardedDeviceBatchIterator
    from contrad_tpu_torch.parallel import gather_rows, mesh, ring_shift_

    torch.set_num_threads(1)
    mesh.init_distributed("cpu")
    data = _dataset()
    res = {}
    live = ShardedDeviceBatchIterator(data, BATCH, seed=SEED, device="cpu")
    res["live"] = _record(live, 6)
    state = live.state_dict()
    res["live"] += _record(live, STEPS - 6)
    res["state"] = state
    resumed = ShardedDeviceBatchIterator(data, BATCH, seed=SEED, device="cpu")
    resumed.load_state_dict(state)
    res["mid_epoch"] = _record(resumed, STEPS - 6)
    at3 = ShardedDeviceBatchIterator(data, BATCH, seed=SEED, device="cpu")
    at3.load_state_dict({"epoch": 3, "pos": 0, "started": False,
                         "sharded_world": WORLD})
    res["epoch3"] = _record(at3, 4)
    two = ShardedDeviceBatchIterator(data, 2 * BATCH, seed=SEED, device="cpu")
    res["n_critic2"] = []
    for _ in range(4):  # 2 steps an epoch: one rotation
        images = two.materialize(two.next_indices()[0])
        res["n_critic2"].append([gather_rows(part).numpy()
                                 for part in images.chunk(2)])
    t = torch.full((3,), float(rank))
    res["ring"] = ring_shift_(t).numpy()
    try:
        ShardedDeviceBatchIterator(data, BATCH, device="cpu").load_state_dict(
            {"epoch": 1, "pos": 0, "started": True})
        res["unsharded_state"] = None
    except ValueError as e:
        res["unsharded_state"] = str(e)
    torch.save(res, f"{out}.rank{rank}.pt")
    mesh.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded") / "checks")
    port = free_port()
    env = dict(worker_env(ROOT), OMP_NUM_THREADS="1")
    spawn_world([([sys.executable, os.path.abspath(__file__), str(r), out],
                  rank_env(env, port, r, WORLD)) for r in range(WORLD)],
                cwd=ROOT, timeout=300)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_iterator(batch=BATCH, start_epoch=0):
    import jax

    from contrad_tpu.data.core import ArrayDataset, ShardedDeviceBatchIterator
    from contrad_tpu.parallel.mesh import get_mesh

    data = _dataset()
    return ShardedDeviceBatchIterator(
        ArrayDataset(data.images, data.labels), batch,
        mesh=get_mesh(jax.devices()[:WORLD]), seed=SEED,
        start_epoch=start_epoch)


def _jax_record(it, steps):
    import jax

    rows = []
    for _ in range(steps):
        left = it.steps_until_rotation()
        idx, labels = it.next_indices()
        rows.append(dict(left=left, idx=idx, labels=labels, epoch=it.epoch,
                         images=np.asarray(jax.device_get(it.materialize(
                             idx))),
                         shards=np.asarray(jax.device_get(it.images))))
    return rows


def _hold(port_ranks, ref, steps):
    """Each rank's steps against JAX's device ``rank``'s."""
    local = BATCH // WORLD
    for rank, port in enumerate(port_ranks):
        mine = slice(rank * local, (rank + 1) * local)
        for s in range(steps):
            got, want = port[s], ref[s]
            assert got["left"] == want["left"], (rank, s)
            assert got["epoch"] == want["epoch"], (rank, s)
            np.testing.assert_array_equal(got["idx"], want["idx"][mine])
            np.testing.assert_array_equal(got["labels"], want["labels"][mine])
            np.testing.assert_array_equal(got["images"], want["images"][mine])
            shard = len(want["shards"]) // WORLD
            np.testing.assert_array_equal(
                got["shard"], want["shards"][rank * shard:(rank + 1) * shard])


def test_three_epochs_match_jax_device_for_device(world):
    ref = _jax_record(_jax_iterator(), STEPS)
    assert [r["epoch"] for r in ref] == [0] * 4 + [1] * 4 + [2] * 4
    _hold([w["live"] for w in world], ref, STEPS)
    assert [r["left"] for r in world[0]["live"][:5]] == [0, 3, 2, 1, 0]


def test_rotation_is_in_place_and_hands_on_the_neighbours_chunk(world):
    for rank, w in enumerate(world):
        assert len({r["storage"] for r in w["live"]}) == 1
        for s in (4, 8):  # the first steps of epochs 1 and 2
            before = world[(rank - 1) % WORLD]["live"][s - 1]["shard"]
            np.testing.assert_array_equal(w["live"][s]["shard"], before)


def test_resume_mid_epoch_continues_the_stream(world):
    assert world[0]["state"] == {"epoch": 1, "pos": 8, "started": True,
                                 "sharded_world": WORLD}
    for w in world:
        for got, want in zip(w["mid_epoch"], w["live"][6:], strict=True):
            for key in ("idx", "labels", "images", "shard"):
                np.testing.assert_array_equal(got[key], want[key])


def test_resume_at_epoch_3_replays_the_rotations(world):
    ref = _jax_record(_jax_iterator(start_epoch=3), 4)
    _hold([w["epoch3"] for w in world], ref, 4)


def test_two_critic_sub_batches_are_jaxs_rows_grouped_by_rank(world):
    """Sub-batch j of the world is every rank's part j in rank order: rows
    ``r * 8 + 4j ... + 4`` of JAX's global batch for r = 0, 1, where JAX's
    sub-batch j is rows ``8j ... 8j + 8``: the same 16 rows."""
    it = _jax_iterator(batch=2 * BATCH)
    for step in range(4):
        import jax

        idx, _ = it.next_indices()
        ref = np.asarray(jax.device_get(it.materialize(idx)))
        for j in range(2):
            want = np.concatenate([ref[r * BATCH + 4 * j:r * BATCH + 4 * j + 4]
                                   for r in range(WORLD)])
            for w in world:  # the gather gives every rank the sub-batch
                np.testing.assert_array_equal(w["n_critic2"][step][j], want)
        got = np.concatenate(world[0]["n_critic2"][step])
        assert sorted(got[:, 0, 0, 0]) == sorted(ref[:, 0, 0, 0])


def test_ring_shift_moves_each_tensor_one_rank_on(world):
    for rank, w in enumerate(world):
        np.testing.assert_array_equal(w["ring"],
                                      np.full(3, (rank - 1) % WORLD))


def test_an_unsharded_position_does_not_resume_a_shard(world):
    assert "cannot resume" in world[0]["unsharded_state"]


# ------------------------------------------- the sharded path in training

RECIPE = ["--device", "cpu", "--dtype", "f64", "--conditional", "--n_critic",
          "2", "--batch", "8", "--steps", "3", "--data_rows", "16"]


def _run(tmp, world, flags):
    out = str(tmp / f"w{world}")
    env = dict(worker_env(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "contrad_tpu_torch.parallel._mh_worker",
           "--out", out, "--world", str(world)] + RECIPE + flags
    port = free_port()
    spawn_world([(cmd + ["--rank", str(r), "--port", str(port)], env)
                 for r in range(world)], cwd=ROOT, timeout=600)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def sharded_recipe(tmp_path_factory):
    """16 rows of 16x16 (12,288 bytes) under a limit of 8,000: sharded in a
    world of 2, 8 rows a rank, 8 rows a rank a step (2 critic sub-batches of
    4): 1 step an epoch, so 3 steps cross 2 rotations."""
    tmp = tmp_path_factory.mktemp("sharded_recipe")
    return (_run(tmp, 2, ["--max_bytes", "8000"]),
            _run(tmp, 1, ["--feed_world", "2"])[0])


def _close(got, want, what):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= 1e-6 * scale + 1e-12, f"{what}: {err:.3g} (scale {scale:.3g})"


def test_sharded_training_feeds_the_streams_rows(sharded_recipe):
    ranks, ref = sharded_recipe
    for rank, r in enumerate(ranks):
        data = r["data"]
        assert data["path"] == "sharded"
        assert data["gathered_equal"] == [True] * 3
        assert [s["epoch"] for s in data["shards"]] == [0, 1, 2]
        assert [s["chunk"] for s in data["shards"]] == [
            rank, (rank - 1) % 2, rank]
        assert all(s["equal"] for s in data["shards"])
        assert len({s["storage"] for s in data["shards"]}) == 1
    assert ref["data"]["path"] == "ShardedFeed"
    assert ref["data"]["gathered_equal"] == [True] * 3
    for step in range(3):  # world 1's batch: each rank's part j, j = 0, 1
        a, b = (r["data"]["rows"][step] for r in ranks)
        assert ref["data"]["rows"][step] == a[:4] + b[:4] + a[4:] + b[4:]


def test_sharded_training_matches_world_one(sharded_recipe):
    (a, b), want = sharded_recipe
    assert a["metrics"] == b["metrics"]
    for key, v in a["state"].items():
        assert torch.equal(v, b["state"][key]), key
    for m_got, m_want in zip(a["metrics"], want["metrics"], strict=True):
        for k in m_want:
            _close(torch.tensor(m_got[k]), torch.tensor(m_want[k]), k)
    assert a["state"].keys() == want["state"].keys()
    for key, v in want["state"].items():
        if v.is_floating_point():
            _close(a["state"][key], v, key)
        else:
            assert torch.equal(a["state"][key], v), key
    for which in ("g_grads", "d_grads"):
        for x, y in zip(a[which][0], want[which][0], strict=True):
            _close(x, y, which)


if __name__ == "__main__":
    world_checks(int(sys.argv[1]), sys.argv[2])
