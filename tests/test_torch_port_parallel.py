"""The building blocks of the port's data parallelism (``contrad_tpu_torch/
parallel/``, ``hostenv.py``, the sharded loader), in a 2-process gloo world
on the CPU in float64, against the same computation in one process.

One world of two processes (``hostenv.spawn_world`` running this file as a
script, ``init_distributed(device="cpu")``) runs every check that needs a
world and writes each rank's results; the tests below read them:

  * ``gather_rows``: forward, the global rows in rank order; backward, this
    rank's slice of the global loss's gradient;
  * ``all_reduce_grads``: the world's sum, over several flat buckets and two
    dtypes, equal on both ranks;
  * ``BatchNorm`` in train mode against one process on the concatenated
    batch: outputs, running statistics, and the gradients of the input,
    the scale and the bias of a global loss;
  * ``minibatch_stddev`` against one process on the global batch, and its
    error where a rank's rows are no multiple of the group;
  * ``world_all``, ``broadcast_floats`` and ``host_batched``.

In one process: the sharded loader's slices of each critic sub-batch tile
the global batch at ``n_critic`` 1 and 2, after a resume too;
``local_rows``; the rendezvous variables; and ``spawn_world`` draining its
pipes concurrently (as ``tests/test_multihost_spawn.py`` holds the JAX
package's) and ending a world whose rank failed.

Tolerances: float64; gathers, sums of two and broadcasts bitwise or within
1e-12 relative; batch-norm and stddev results within rtol 1e-10 (the
world's statistics are sums in another order).
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from contrad_tpu_torch.data.core import ArrayDataset, DeviceBatchIterator  # noqa: E402
from contrad_tpu_torch.hostenv import (  # noqa: E402
    free_port, rank_env, spawn_world, worker_env)
from contrad_tpu_torch.parallel import mesh  # noqa: E402
from contrad_tpu_torch.parallel.mesh import local_rows  # noqa: E402

WORLD = 2
N, C = 8, 3  # global rows, channels
TOL = dict(rtol=1e-10, atol=1e-12)


def _inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.normal(size=(N, C)), w=rng.normal(size=(N, C)),
        grads=[rng.normal(size=(WORLD, 4, 3)), rng.normal(size=(WORLD, 7)),
               rng.normal(size=(WORLD, 2, 2)).astype(np.float32),
               rng.normal(size=(WORLD, 5))],
        bn_x=rng.normal(size=(N, C, 2, 2)) * 3 + 1,
        bn_w=rng.normal(size=(N, C, 2, 2)),
        sd_x=rng.normal(size=(N, 4, 4, 2)), feat_x=rng.uniform(
            size=(N + 3, 4, 4, 3)))


def _bn(x_np, loss_w, gather):
    """A train-mode BatchNorm (non-trivial scale and bias) on ``x_np`` and
    the global loss sum(y * loss_w); returns y, the running statistics and
    the gradients of x, the scale and the bias."""
    from contrad_tpu_torch.models.sndcgan import BatchNorm
    from contrad_tpu_torch.parallel import all_reduce_grads

    bn = BatchNorm(C).double()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.3, 0.7]))
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = bn(x, train=True)
    loss = (gather(y) * torch.from_numpy(loss_w)).sum()
    gx, gw, gb = torch.autograd.grad(loss, [x, bn.weight, bn.bias])
    gw, gb = all_reduce_grads([gw, gb])
    return dict(y=y.detach().numpy(), mean=bn.running_mean.numpy().copy(),
                var=bn.running_var.numpy().copy(), gx=gx.numpy(),
                gw=gw.numpy(), gb=gb.numpy())


def world_checks(rank: int, out: str) -> None:
    """Every check that needs the world, as rank ``rank``; results to
    ``out``."""
    from contrad_tpu_torch.models.stylegan2.discriminator import (
        minibatch_stddev)
    from contrad_tpu_torch.parallel import (
        all_reduce_grads, broadcast_floats, collectives, gather_rows,
        host_batched, world_all)

    torch.set_num_threads(1)
    device = mesh.init_distributed("cpu")
    assert device == torch.device("cpu")
    inp = _inputs()
    per = N // WORLD
    mine = slice(rank * per, (rank + 1) * per)
    res = {"shard": mesh.data_shard(), "backend": mesh.backend()}

    x = torch.from_numpy(inp["x"][mine]).requires_grad_(True)
    y = gather_rows(x)
    loss = (y ** 2 * torch.from_numpy(inp["w"])).sum()
    (gx,) = torch.autograd.grad(loss, x)
    res.update(gather=y.detach().numpy(), gather_grad=gx.numpy())

    collectives.BUCKET_ELEMENTS = 20  # several buckets for these sizes
    reduced = all_reduce_grads([torch.from_numpy(g[rank]) for g in
                                inp["grads"]])
    res["reduced"] = [g.numpy() for g in reduced]

    res["bn"] = _bn(inp["bn_x"][mine], inp["bn_w"], gather_rows)
    res["stddev"] = minibatch_stddev(
        torch.from_numpy(inp["sd_x"][mine])).numpy()
    try:  # two rows a rank: a global batch of 4 has groups of 4
        minibatch_stddev(torch.from_numpy(inp["sd_x"][:2]))
        res["stddev_error"] = None
    except ValueError as e:
        res["stddev_error"] = str(e)

    res["all_true"] = world_all(True)
    res["one_true"] = world_all(rank == 0)
    res["floats"] = broadcast_floats(rank + 0.5, 3.0 * (rank + 1))
    res["features"] = host_batched(lambda t: t.mean(dim=(1, 2)), "cpu",
                                   chunk=2)(inp["feat_x"])
    res["counts"] = dict(collectives.counts)
    torch.save(res, f"{out}.rank{rank}.pt")
    mesh.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel") / "checks")
    port = free_port()
    env = dict(worker_env(ROOT), OMP_NUM_THREADS="1")
    spawn_world([([sys.executable, os.path.abspath(__file__), str(r), out],
                  rank_env(env, port, r, WORLD)) for r in range(WORLD)],
                cwd=ROOT, timeout=300)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _rows(a, rank):
    per = len(a) // WORLD
    return a[rank * per:(rank + 1) * per]


def test_the_world_is_two_gloo_processes(world):
    assert [r["shard"] for r in world] == [(0, 2), (1, 2)]
    assert {r["backend"] for r in world} == {"gloo"}


def test_gather_rows_forward_is_the_global_batch_in_rank_order(world, inputs):
    for r in world:
        np.testing.assert_array_equal(r["gather"], inputs["x"])


def test_gather_rows_backward_keeps_this_ranks_slice(world, inputs):
    want = 2 * inputs["x"] * inputs["w"]
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r["gather_grad"], _rows(want, rank), **TOL)


def test_all_reduce_grads_sums_over_the_world_in_buckets(world, inputs):
    for r in world:
        assert len(r["reduced"]) == len(inputs["grads"])
        for got, g in zip(r["reduced"], inputs["grads"]):
            assert got.dtype == g.dtype and got.shape == g.shape[1:]
            np.testing.assert_array_equal(got, g[0] + g[1])
    assert world[0]["counts"]["calls"] > len(inputs["grads"])  # buckets


def test_batch_norm_in_a_world_matches_one_process(world, inputs):
    want = _bn(inputs["bn_x"], inputs["bn_w"], lambda t: t)
    for rank, r in enumerate(world):
        got = r["bn"]
        for key in ("y", "gx"):
            np.testing.assert_allclose(got[key], _rows(want[key], rank),
                                       **TOL, err_msg=key)
        for key in ("mean", "var", "gw", "gb"):
            np.testing.assert_allclose(got[key], want[key], **TOL,
                                       err_msg=key)
    for key in ("mean", "var", "gw", "gb"):  # replicas stay equal
        np.testing.assert_array_equal(world[0]["bn"][key],
                                      world[1]["bn"][key])


def test_batch_norm_keeps_the_biased_variance(world, inputs):
    x = inputs["bn_x"]
    var = x.transpose(1, 0, 2, 3).reshape(C, -1).var(axis=1)
    np.testing.assert_allclose(world[0]["bn"]["var"], 0.9 + 0.1 * var, **TOL)


def test_minibatch_stddev_in_a_world_matches_one_process(world, inputs):
    from contrad_tpu_torch.models.stylegan2.discriminator import (
        minibatch_stddev)

    want = minibatch_stddev(torch.from_numpy(inputs["sd_x"])).numpy()
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r["stddev"], _rows(want, rank), **TOL)


def test_minibatch_stddev_refuses_groups_across_ranks(world):
    for r in world:
        assert r["stddev_error"] is not None
        assert "global batch of 4 on 2 processes" in r["stddev_error"]
        assert "stddev group 4" in r["stddev_error"]


def test_stddev_group_size_rule():
    from contrad_tpu_torch.models.stylegan2.discriminator import (
        stddev_group_size)

    assert stddev_group_size(8, 2) == 4
    with pytest.raises(ValueError, match="stddev group 2"):
        stddev_group_size(1, 2)
    with pytest.raises(ValueError, match="global batch of 8 on 4 processes "
                                         "leaves 2 rows a rank"):
        stddev_group_size(2, 4)
    assert stddev_group_size(4, 1) == 4
    assert stddev_group_size(3, 1) == 3


def test_world_all(world):
    assert [r["all_true"] for r in world] == [True, True]
    assert [r["one_true"] for r in world] == [False, False]


def test_broadcast_floats_gives_rank_zeros_values(world):
    for r in world:
        assert r["floats"] == (0.5, 3.0)


def test_host_batched_gives_every_row_on_every_rank(world, inputs):
    want = inputs["feat_x"].mean(axis=(1, 2))
    for r in world:
        assert r["features"].shape == want.shape
        np.testing.assert_allclose(r["features"], want, **TOL)


def test_outside_a_world_the_helpers_are_the_identity():
    from contrad_tpu_torch.parallel import (
        all_reduce_grads, broadcast_floats, gather_rows, global_var_mean,
        world_all)

    assert not mesh.in_world() and mesh.data_shard() == (0, 1)
    x = torch.randn(4, 3, dtype=torch.float64)
    assert gather_rows(x) is x
    grads = [x, x[0]]
    assert all(a is b for a, b in zip(all_reduce_grads(grads), grads))
    var, mean = global_var_mean(x, [0])
    want_var, want_mean = torch.var_mean(x, dim=0, correction=0)
    assert torch.equal(var, want_var) and torch.equal(mean, want_mean)
    assert world_all(True) and not world_all(False)
    assert broadcast_floats(1.5, 2.0) == (1.5, 2.0)
    assert mesh.round_up_batch(7, 2) == 8 and mesh.round_up_batch(8, 2) == 8


# ---------------------------------------------------- in one process

def _dataset(n=24):
    rng = np.random.default_rng(3)
    return ArrayDataset(rng.integers(0, 256, size=(n, 2, 2, 3),
                                     dtype=np.uint8),
                        rng.integers(0, 10, size=n), n_classes=10)


@pytest.mark.parametrize("n_critic", [1, 2])
def test_sharded_loader_slices_tile_each_critic_sub_batch(n_critic):
    """Each rank's rows of each sub-batch, stacked rank after rank, are the
    global sub-batch; across an epoch boundary, and from a resumed
    position."""
    batch, data = 4, _dataset()
    whole = DeviceBatchIterator(data, batch * n_critic, seed=5, device="cpu")
    ranks = [DeviceBatchIterator(data, batch * n_critic, seed=5,
                                 device="cpu", shard=(r, WORLD),
                                 parts=n_critic) for r in range(WORLD)]
    states = None
    for step in range(8):  # 24 rows: an epoch is 6 / n_critic steps
        if step == 5:
            states = [it.state_dict() for it in ranks]
            assert all(s == whole.state_dict() for s in states)
        idx, labels = whole.next_indices()
        got = [it.next_indices() for it in ranks]
        for part in range(n_critic):
            sub = idx[part * batch:(part + 1) * batch]
            tiles = np.concatenate([g[0].reshape(n_critic, -1)[part]
                                    for g in got])
            np.testing.assert_array_equal(tiles, sub)
        for g in got:
            np.testing.assert_array_equal(g[1], data.labels[g[0]])
    resumed = [DeviceBatchIterator(data, batch * n_critic, seed=5,
                                   device="cpu", shard=(r, WORLD),
                                   parts=n_critic) for r in range(WORLD)]
    replay = [DeviceBatchIterator(data, batch * n_critic, seed=5,
                                  device="cpu", shard=(r, WORLD),
                                  parts=n_critic) for r in range(WORLD)]
    for it, s in zip(resumed, states):
        it.load_state_dict(s)
    for it in replay:
        for _ in range(5):
            it.next_indices()
    for _ in range(3):
        for a, b in zip(resumed, replay):
            np.testing.assert_array_equal(a.next_indices()[0],
                                          b.next_indices()[0])


def test_sharded_loader_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="global batch 5 must divide "
                                         "device count 2"):
        DeviceBatchIterator(_dataset(), 5, device="cpu", shard=(0, 2))
    with pytest.raises(ValueError, match="bad shard"):
        DeviceBatchIterator(_dataset(), 4, device="cpu", shard=(2, 2))


def test_local_rows_slices_each_part_and_keeps_per_batch_draws():
    batch = 4
    tree = {"v": torch.arange(3 * batch), "s": torch.tensor(True),
            "l": [np.arange(batch * 2)], "t": (torch.arange(batch), None)}
    got = local_rows(tree, batch, shard=(1, 2))
    np.testing.assert_array_equal(got["v"], [2, 3, 6, 7, 10, 11])
    assert got["s"] is tree["s"]
    np.testing.assert_array_equal(got["l"][0], [2, 3, 6, 7])
    np.testing.assert_array_equal(got["t"][0], [2, 3])
    assert got["t"][1] is None
    assert local_rows(tree, batch, shard=(0, 1)) is tree
    with pytest.raises(ValueError, match="no whole number"):
        local_rows(torch.arange(6), batch, shard=(0, 2))


def test_rendezvous_from_the_ports_and_torchruns_variables(monkeypatch):
    from contrad_tpu_torch.hostenv import RENDEZVOUS_VARS

    for k in RENDEZVOUS_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs a rendezvous"):
        mesh._rendezvous()
    for k, v in rank_env({}, 1234, 1, 2).items():
        monkeypatch.setenv(k, v)
    assert mesh._rendezvous() == ("127.0.0.1:1234", 2, 1, -1)
    for k in RENDEZVOUS_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(MASTER_ADDR="10.0.0.1", MASTER_PORT="29500", RANK="3",
                     WORLD_SIZE="4", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    assert mesh._rendezvous() == ("10.0.0.1:29500", 4, 3, 1)
    env = worker_env(ROOT)
    assert not set(RENDEZVOUS_VARS) & set(env)
    assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT


def test_init_distributed_refuses_nccl_on_the_cpu(monkeypatch):
    for k, v in rank_env({}, free_port(), 0, 1, "nccl").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nccl backend needs cuda"):
        mesh.init_distributed("cpu")
    assert not mesh.in_world()


def test_spawn_world_drains_pipes_concurrently(tmp_path):
    """A rank that floods its pipe before the file the other rank waits on
    must not deadlock the world (as the JAX package's
    ``tests/test_multihost_spawn.py:279``)."""
    flag = str(tmp_path / "rank1_done")
    waiter = (f"import os, time\n"
              f"deadline = time.time() + 60\n"
              f"while not os.path.exists({flag!r}):\n"
              f"    assert time.time() < deadline, 'barrier timeout'\n"
              f"    time.sleep(0.05)\n"
              f"print('rank0 ok')\n")
    flooder = (f"import sys, pathlib\n"
               f"sys.stdout.write('x' * 300_000)\n"
               f"sys.stdout.flush()\n"
               f"pathlib.Path({flag!r}).touch()\n")
    env = dict(os.environ)
    outs = spawn_world([([sys.executable, "-c", waiter], env),
                        ([sys.executable, "-c", flooder], env)],
                       cwd=ROOT, timeout=90)
    assert "rank0 ok" in outs[0]
    assert len(outs[1]) >= 300_000


def test_spawn_world_ends_the_world_when_a_rank_fails():
    import time

    env = dict(os.environ)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rc=3") as e:
        spawn_world([([sys.executable, "-c", "import time; time.sleep(60)"],
                      env),
                     ([sys.executable, "-c", "print('rank1 failed'); "
                       "raise SystemExit(3)"], env)], cwd=ROOT, timeout=90)
    assert "rank1 failed" in str(e.value)
    assert time.monotonic() - t0 < 30


if __name__ == "__main__":
    world_checks(int(sys.argv[1]), sys.argv[2])
