"""The port's host-fed data path (``contrad_tpu_torch/data/core.py``:
``BatchIterator``, ``PrefetchIterator``, ``make_train_loader``, and
``data/native.py`` over ``csrc/batch_gather.cpp``) against the JAX
package's (``contrad_tpu/data/core.py``, ``contrad_tpu/data/native``), with
the same numpy inputs. Every comparison is exact: uint8 images, int64
labels and integer rows.

  * ``BatchIterator`` over 3 epochs, whole and with ``shard`` (JAX's rows
    at ``parts`` 1; at ``parts`` 2 each rank's part of every critic
    sub-batch, the port's world convention), and its ``state_dict`` resume
    mid-epoch;
  * the native gather at 30 MB (the threaded C++ path) and at 1 MB
    (``np.take``, and the library forced), ``shuffled_indices``, and a
    build that fails raising;
  * ``PrefetchIterator``: the same batches in order, ``close()`` stopping
    its worker (JAX's ``test_prefetch_iterator_close_stops_worker``), a
    resume after 3 batches at depth 2 giving batch 4, the worker's error
    raised by the consumer;
  * ``make_train_loader``'s three-way choice under a patched
    ``DeviceBatchIterator.MAX_BYTES``, for worlds of 1 and 2, and the
    device-resident iterator refusing a set above it.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from contrad_tpu.data import native as jax_native
from contrad_tpu.data.core import ArrayDataset as JaxDataset
from contrad_tpu.data.core import BatchIterator as JaxBatchIterator
from contrad_tpu_torch.data import (
    ArrayDataset, BatchIterator, DeviceBatchIterator, PrefetchIterator,
    ShardedDeviceBatchIterator, make_train_loader, native)

BATCH = 8


def _data(n=50, size=(4, 4, 3), seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n,) + size, dtype=np.uint8)
    labels = rng.integers(0, 10, size=n)
    return ArrayDataset(images, labels, n_classes=10), JaxDataset(images,
                                                                  labels)


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
@pytest.mark.parametrize("parts", [1, 2])
def test_batch_iterator_matches_jax_over_three_epochs(shard, parts):
    """50 rows, 8 a step: 6 steps an epoch, 2 rows dropped; 18 steps."""
    data, jax_data = _data()
    port = BatchIterator(data, BATCH, seed=3, shard=shard, parts=parts)
    ref = JaxBatchIterator(jax_data, BATCH, seed=3,
                           shard=shard if parts == 1 else None)
    for _ in range(18):
        images, labels = next(port)
        want_images, want_labels = next(ref)
        if parts > 1 and shard is not None:
            # this rank's rows of each critic sub-batch of JAX's global batch
            rank, world = shard
            per = BATCH // parts // world
            pick = np.concatenate([np.arange(p * BATCH // parts + rank * per,
                                             p * BATCH // parts
                                             + (rank + 1) * per)
                                   for p in range(parts)])
            want_images, want_labels = want_images[pick], want_labels[pick]
        np.testing.assert_array_equal(images, want_images)
        np.testing.assert_array_equal(labels, want_labels)
        assert labels.dtype == np.int64 and images.dtype == np.uint8
    assert port.epoch == ref.epoch == 2
    assert port.rows == BATCH // (1 if shard is None else shard[1])


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_batch_iterator_resumes_mid_epoch(shard):
    data, _ = _data()
    live = BatchIterator(data, BATCH, seed=3, shard=shard, parts=2)
    for _ in range(10):  # into the second epoch
        next(live)
    state = live.state_dict()
    assert state == {"epoch": 1, "pos": 32, "started": True}
    resumed = BatchIterator(data, BATCH, seed=3, shard=shard, parts=2)
    resumed.load_state_dict(state)
    for _ in range(9):  # across the next two epoch boundaries
        np.testing.assert_array_equal(resumed.next_indices(),
                                      live.next_indices())
    assert resumed.epoch == live.epoch == 3


def test_device_batch_iterator_draws_the_batch_iterators_rows():
    data, _ = _data()
    device = DeviceBatchIterator(data, BATCH, seed=3, device="cpu",
                                 shard=(1, 2), parts=2)
    host = BatchIterator(data, BATCH, seed=3, shard=(1, 2), parts=2)
    for _ in range(9):
        idx, labels = device.next_indices()
        rows = host.next_indices()
        np.testing.assert_array_equal(idx, rows)
        np.testing.assert_array_equal(labels, data.labels[rows])
        assert idx.dtype == np.int32
    assert device.state_dict() == host.state_dict()


@pytest.mark.parametrize("rows", [40, 4], ids=["31MB", "3MB"])
def test_native_gather_matches_jax(rows):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, size=(48, 512, 512, 3), dtype=np.uint8)
    idx = rng.integers(0, len(src), size=rows)
    want = jax_native.gather_batch(src, idx)
    got = native.gather_batch(src, idx)
    assert (rows * src[0].nbytes >= native.NATIVE_MIN_BYTES) == (rows == 40)
    np.testing.assert_array_equal(got, want)
    out = np.empty_like(want)
    for threads in (0, 1, 3):  # the library at any size and thread count
        out[:] = 0
        native.gather_native(src, idx, out, n_threads=threads)
        np.testing.assert_array_equal(out, want)
    pinned_like = np.zeros_like(want)
    assert native.gather_batch(src, idx, out=pinned_like) is pinned_like
    np.testing.assert_array_equal(pinned_like, want)


def test_native_gather_of_1mb_matches_jax():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 256, size=(600, 32, 32, 3), dtype=np.uint8)
    idx = rng.permutation(600)[:340]  # 1.04 MB: below the native rule
    np.testing.assert_array_equal(native.gather_batch(src, idx),
                                  jax_native.gather_batch(src, idx))


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 7), (50000, 2**63 + 5)])
def test_shuffled_indices_match_jax(n, seed):
    got = native.shuffled_indices(n, seed)
    np.testing.assert_array_equal(got, jax_native.shuffled_indices(n, seed))
    assert got.dtype == np.int64 and sorted(got) == list(range(n))


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "batch_gather.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOURCE", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_library", None)
    src = np.zeros((4, 2, 2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.gather_batch(src, [0, 1])
    data, _ = _data()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        next(BatchIterator(data, BATCH))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PrefetchIterator(BatchIterator(data, BATCH), device="cpu")


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_yields_the_streams_batches_in_order(depth):
    data, _ = _data()
    port = PrefetchIterator(BatchIterator(data, BATCH, seed=3,
                                          shard=(0, 2), parts=2),
                            device="cpu", depth=depth)
    ref = BatchIterator(data, BATCH, seed=3, shard=(0, 2), parts=2)
    for _ in range(14):
        images, labels = next(port)
        want_images, want_labels = next(ref)
        assert isinstance(images, torch.Tensor) and images.dtype == torch.uint8
        np.testing.assert_array_equal(images.numpy(), want_images)
        np.testing.assert_array_equal(labels.numpy(), want_labels)
    assert port.state_dict() == ref.state_dict()
    assert port.stats["batches"] == 14
    port.close()


def test_prefetch_close_stops_worker():
    """close() stops a put-blocked worker: the wrapped stream is no longer
    consumed and the thread exits."""
    consumed = itertools.count()
    data, _ = _data()

    class Counting(BatchIterator):
        def next_batch(self, out=None):
            next(consumed)
            return super().next_batch(out)

    it = PrefetchIterator(Counting(data, BATCH), device="cpu", depth=1)
    next(it)
    thread = it._thread
    time.sleep(0.3)  # let the worker fill the queue and block on put
    it.close()
    assert not thread.is_alive(), "worker thread still running after close()"
    n_after_close = next(consumed)
    time.sleep(0.3)
    assert next(consumed) == n_after_close + 1, "stream consumed after close()"


def test_prefetch_resumes_at_the_consumers_position():
    """After 3 batches at depth 2 the worker has gathered further; the state
    is the consumer's, so a resumed stream's next batch is batch 4, and so
    is this stream's after close()."""
    data, _ = _data()
    ref = BatchIterator(data, BATCH, seed=4)
    batches = [next(ref) for _ in range(5)]
    it = PrefetchIterator(BatchIterator(data, BATCH, seed=4), device="cpu",
                          depth=2)
    for _ in range(3):
        next(it)
    time.sleep(0.3)  # the worker runs ahead
    state = it.state_dict()
    assert state == {"epoch": 0, "pos": 24, "started": True}
    resumed = PrefetchIterator(BatchIterator(data, BATCH, seed=4),
                               device="cpu", depth=2)
    resumed.load_state_dict(state)
    np.testing.assert_array_equal(next(resumed)[0].numpy(), batches[3][0])
    it.close()
    np.testing.assert_array_equal(next(it)[0].numpy(), batches[3][0])
    np.testing.assert_array_equal(next(it)[0].numpy(), batches[4][0])
    it.close()
    resumed.close()


def test_prefetch_raises_the_workers_error():
    data, _ = _data()

    class Failing(BatchIterator):
        def next_batch(self, out=None):
            if self.epoch == 0 and self._pos >= 2 * BATCH:
                raise OSError("a row could not be read")
            return super().next_batch(out)

    it = PrefetchIterator(Failing(data, BATCH), device="cpu")
    next(it), next(it)
    with pytest.raises(OSError, match="could not be read"):
        next(it)
    assert it.state_dict()["pos"] == 2 * BATCH


def _choose(monkeypatch, limit, world, data):
    monkeypatch.setattr(DeviceBatchIterator, "MAX_BYTES", limit)
    loader = make_train_loader(data, 4, 2, seed=0, device="cpu",
                               shard=(world - 1, world))
    if isinstance(loader, PrefetchIterator):
        loader.close()
    return loader


@pytest.mark.parametrize("world", [1, 2])
def test_make_train_loader_chooses_by_size(monkeypatch, world):
    data, _ = _data()  # 2,400 bytes
    loader = _choose(monkeypatch, 2400, world, data)
    assert isinstance(loader, DeviceBatchIterator)
    assert loader.batch_size == 8 and loader.shard == (
        None if world == 1 else (1, 2))
    loader = _choose(monkeypatch, 1200, world, data)
    if world == 1:  # one card: no sharding, host-fed
        assert isinstance(loader, PrefetchIterator)
    else:
        assert isinstance(loader, ShardedDeviceBatchIterator)
        assert (loader.rank, loader.world, loader.local_batch) == (1, 2, 4)
        assert loader.images.shape == (25, 4, 4, 3)
    loader = _choose(monkeypatch, 1199, world, data)
    assert isinstance(loader, PrefetchIterator)
    assert loader._it.rows == 8 // world and loader._it.parts == 2
    assert loader._it.shard == (None if world == 1 else (1, 2))


def test_device_residency_refuses_a_set_above_max_bytes(monkeypatch):
    assert DeviceBatchIterator.MAX_BYTES == 16 * 2**30
    data, _ = _data()
    monkeypatch.setattr(DeviceBatchIterator, "MAX_BYTES", 2399)
    with pytest.raises(ValueError, match="too large for device residency"):
        DeviceBatchIterator(data, BATCH, device="cpu")
