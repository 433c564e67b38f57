"""The port's multi-step dispatch sizing (``contrad_tpu_torch/training/
dispatch.py``) against the JAX package's (``contrad_tpu/training/
dispatch.py``) on the same inputs: the K that ``resolve_steps_per_dispatch``
picks over a grid of requested K, cadences, trace flag and loaders; the
block sizes of ``block_size`` over steps, K, max_steps and epoch rotations;
and ``BlockDispatcher``'s blocks (kinds, sizes, index vectors, labels and the
deferred gather) over whole simulated runs from several start steps, on the
port's ``DeviceBatchIterator`` and on fake loaders. Every case of
``tests/test_dispatch.py`` is here, the event-coverage simulation included.
All exact: the copy makes the same integer decisions."""

import itertools

import numpy as np
import pytest

from contrad_tpu.training import dispatch as jax_dispatch
from contrad_tpu_torch.data import DeviceBatchIterator, get_dataset
from contrad_tpu_torch.training import dispatch

CADENCES = [(50, 2000, 100000), (160, 1600), (7, 2000), (50, 2000),
            (1, 5000, 100000), (4, 8, 16), (0, 12), (50, 5000, 100000)]


@pytest.mark.parametrize("cadences", CADENCES)
@pytest.mark.parametrize("requested", [0, 1, 2, 4, 10, 16, 48])
@pytest.mark.parametrize("fuse_gather,trace_steps", [
    (True, 0), (False, 0), (True, 5)])
def test_resolved_k_matches_jax(cadences, requested, fuse_gather,
                                trace_steps):
    args = (requested, fuse_gather, trace_steps) + cadences
    assert (dispatch.resolve_steps_per_dispatch(*args)
            == jax_dispatch.resolve_steps_per_dispatch(*args))
    assert (dispatch.resolve_steps_per_dispatch(*args, cap=8)
            == jax_dispatch.resolve_steps_per_dispatch(*args, cap=8))


def test_resolved_k_of_the_readme_recipes():
    """The JAX CLIs' defaults (print 50, evaluate 2000 or 5000, save
    100000) give K = 10; an explicit 16 is clamped to a divisor; tracing
    and a prime cadence give 1."""
    for args, want in (((0, True, 0, 50, 2000, 100000), 10),
                       ((0, True, 0, 50, 5000, 100000), 10),
                       ((0, True, 0, 160, 1600), 16),
                       ((0, True, 0, 7, 2000), 1),
                       ((16, True, 0, 50, 2000), 2),
                       ((10, True, 0, 50, 2000), 10),
                       ((1, True, 0, 50, 2000), 1),
                       ((0, False, 0, 50), 1),
                       ((0, True, 5, 50), 1)):
        assert dispatch.resolve_steps_per_dispatch(*args) == want
        assert jax_dispatch.resolve_steps_per_dispatch(*args) == want


class _RotatingLoader:
    def __init__(self, until):
        self._until = until

    def steps_until_rotation(self):
        return self._until


@pytest.mark.parametrize("loader", [object(), _RotatingLoader(10**9),
                                    _RotatingLoader(3), _RotatingLoader(4),
                                    _RotatingLoader(0),
                                    _RotatingLoader(None)],
                         ids=["plain", "far", "3", "4", "0", "none"])
def test_block_sizes_match_jax(loader):
    for step, k, max_steps in itertools.product(range(1, 40), [1, 2, 3, 4,
                                                               10, 16],
                                                [1, 17, 20, 37, 100]):
        assert (dispatch.block_size(step, k, max_steps, loader)
                == jax_dispatch.block_size(step, k, max_steps, loader)), (
            step, k, max_steps)


def _plain(x):
    """Lists and numbers of arrays, tensors and tuples, to compare runs."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _walk(module, loader_fn, k, max_steps, start, rotation_at=None):
    """A train CLI's loop over ``module``'s dispatcher, from ``start`` to
    ``max_steps``: every block (kind, size, index vectors, labels, the
    last batch) and every step where a print every 4 steps would fire."""
    loader = loader_fn()
    d = module.BlockDispatcher(loader, k, max_steps)
    out, fired, step = [], [], start
    while step <= max_steps:
        if rotation_at is not None:
            loader.until = max(0, rotation_at - step)
        blk = d.next_block(step)
        rows = (blk.idx_block if blk.kind == "block"
                else None if blk.idx is None else blk.idx[None])
        labels = (blk.labels_block if blk.kind == "block" else
                  [blk.labels])
        out.append((blk.kind, blk.k, _plain(rows), _plain(labels),
                    _plain(blk.materialize())))
        step += blk.k - 1
        if step % 4 == 0:
            fired.append(step)
        step += 1
    return out, fired


class _IndexLoader:
    """An index-vector loader (as ``tests/test_dispatch.py``'s), with a
    settable epoch rotation and a deferred gather."""

    supports_indexed = True
    local_indexing = False

    def __init__(self, batch=4):
        self._n = 0
        self.batch = batch
        self.until = None
        self.gathers = 0

    def steps_until_rotation(self):
        return self.until

    def next_indices(self):
        start = self._n * self.batch
        self._n += 1
        idx = np.arange(start, start + self.batch)
        return idx, idx % 10

    def materialize(self, idx):
        self.gathers += 1
        return ("batch", tuple(int(i) for i in idx))


class _HostLoader:
    """A loader with no index vectors: batches already on the device."""

    def __init__(self):
        self._n = 0

    def __iter__(self):
        return self

    def __next__(self):
        self._n += 1
        return f"HOSTBATCH{self._n}", f"LABELS{self._n}"


def _port_loader():
    train, _, _ = get_dataset("synthetic_8_64")
    return DeviceBatchIterator(train, 12, seed=5, device="cpu",
                               with_labels=True)


@pytest.mark.parametrize("start", [1, 3, 5, 9])
@pytest.mark.parametrize("loader,k", [
    ("index", 1), ("index", 2), ("index", 4), ("index", 10),
    ("rotating", 2), ("rotating", 4), ("rotating", 10),
    ("host", 1)])  # a loader without index vectors resolves K = 1
def test_dispatched_runs_match_jax(loader, start, k):
    """Whole runs of 23 steps: the same blocks, index vectors, labels and
    event steps from either package's dispatcher."""
    make = {"index": _IndexLoader, "host": _HostLoader,
            "rotating": _IndexLoader}[loader]
    rotation_at = 13 if loader == "rotating" else None
    port = _walk(dispatch, make, k, 23, start, rotation_at)
    ref = _walk(jax_dispatch, make, k, 23, start, rotation_at)
    assert port == ref


def test_dispatcher_on_the_ports_loader_matches_jax():
    """The port's ``DeviceBatchIterator`` under both dispatchers: the same
    blocks (its index vectors and host labels), its epochs crossed, and the
    deferred gather the images of the block's last rows."""
    train, _, _ = get_dataset("synthetic_8_64")
    port = _walk(dispatch, _port_loader, 4, 14, 1)
    ref = _walk(jax_dispatch, _port_loader, 4, 14, 1)
    assert port == ref
    blocks, _ = port
    assert [b[:2] for b in blocks] == [("block", 4)] * 3 + [("indexed", 1)] * 2
    for kind, _, rows, labels, last in blocks:
        np.testing.assert_array_equal(last, train.images[rows[-1]])
        np.testing.assert_array_equal(labels[-1], train.labels[rows[-1]])
    loader = _port_loader()
    assert loader.supports_indexed and not loader.local_indexing
    idx, labels = loader.next_indices()
    assert idx.dtype == np.int32 and labels.dtype == np.int64


def test_block_and_single_paths():
    """``tests/test_dispatch.py``'s dispatcher case on the port's copy: a
    full block gathers nothing until asked, its last rows once; a
    misaligned step is a single indexed step continuing the stream; a
    loader without index vectors yields its batches."""
    ld = _IndexLoader()
    d = dispatch.BlockDispatcher(ld, k_dispatch=4, max_steps=100)
    blk = d.next_block(step=1)
    assert blk.kind == "block" and blk.k == 4
    assert blk.idx_block.shape == (4, 4)
    np.testing.assert_array_equal(blk.idx, blk.idx_block[-1])
    assert len(blk.labels_block) == 4 and ld.gathers == 0
    assert blk.materialize()[1] == tuple(blk.idx) and ld.gathers == 1
    blk.materialize()
    assert ld.gathers == 1
    blk2 = d.next_block(step=3)
    assert blk2.kind == "indexed" and blk2.k == 1 and blk2.idx[0] == 16
    blk3 = dispatch.BlockDispatcher(_HostLoader(), 1, 10).next_block(1)
    assert blk3.kind == "batch" and blk3.k == 1
    assert blk3.materialize() == "HOSTBATCH1" and blk3.labels == "LABELS1"


def test_event_coverage_over_a_simulated_run():
    """``tests/test_dispatch.py``'s walk: every print lands on a block end
    (or a single step), with a mid-run rotation forcing singles; the same
    steps fire under both packages' ``block_size``."""
    def fired(module):
        k, print_every, max_steps, rotation_at = 10, 50, 200, 73
        out, step = [], 1
        while step <= max_steps:
            until = max(0, rotation_at - step)
            step += module.block_size(step, k, max_steps,
                                      _RotatingLoader(until)) - 1
            if step % print_every == 0:
                out.append(step)
            step += 1
        return out

    assert fired(dispatch) == fired(jax_dispatch) == [50, 100, 150, 200]
