"""Multi-step dispatch sizing for the training CLIs (the port of
``contrad_tpu/training/dispatch.py``).

K train steps per dispatch: on the card a block of K steps is K replays of
the step's CUDA graphs, enqueued back to back with no host sync
(``training/graph.py``); on the CPU the same block runs its K steps
eagerly. The CLIs keep their event semantics (print, evaluate and save fire
at exact step numbers) by choosing K that divides every cadence and only
launching blocks at aligned steps; the eager single step handles tails,
misalignment and trace capture.
"""

from __future__ import annotations

import math

import numpy as np


def resolve_steps_per_dispatch(requested: int, fuse_gather: bool,
                               trace_steps: int, *cadences: int,
                               cap: int = 16) -> int:
    """Largest safe K: divides every event cadence, <= cap (or <= the user's
    explicit request). 1 whenever blocks can't apply (no index-vector
    loader, or a profiler trace needs per-step boundaries)."""
    if not fuse_gather or trace_steps > 0 or requested == 1:
        return 1
    g = 0
    for c in cadences:
        g = math.gcd(g, max(int(c), 0))
    if g <= 1:
        return 1
    if requested > 0:
        return math.gcd(g, requested)
    limit = min(g, cap)
    return max(d for d in range(1, limit + 1) if g % d == 0)


def block_size(step: int, k: int, max_steps: int, loader) -> int:
    """Size of the dispatch block starting at ``step``: K when aligned, fits
    before max_steps, and (sharded loaders) doesn't straddle an epoch-boundary
    ring rotation; else 1."""
    if k <= 1 or (step - 1) % k:
        return 1
    if step + k - 1 > max_steps:
        return 1
    until_rot = getattr(loader, "steps_until_rotation", None)
    if until_rot is not None:
        left = until_rot()
        if left is not None and left < k:
            return 1
    return k


class Block:
    """One dispatch's worth of training data.

    ``kind`` is ``"block"`` (k>1 steps: graph replays on the card),
    ``"indexed"`` (a single step from an index vector), or ``"batch"`` (a
    batch already on the device). ``materialize()`` returns the block's LAST
    image batch, gathering lazily: a block never gathers pixels on the host
    side unless an evaluation's preview needs them."""

    def __init__(self, kind: str, k: int, loader, idx=None, idx_block=None,
                 batch=None, labels=None, labels_block=None):
        self.kind = kind
        self.k = k
        self.idx = idx
        self.idx_block = idx_block
        self.labels = labels
        self.labels_block = labels_block
        self._loader = loader
        self._batch = batch

    def materialize(self):
        if self._batch is None:
            self._batch = self._loader.materialize(self.idx)
        return self._batch


class BlockDispatcher:
    """The CLI-side multi-step dispatch driver, shared by the training CLIs:
    block alignment via :func:`block_size`, fetching exactly k index
    vectors, stacking them for the block, per-step label collection, and
    deferred batch materialization. The caller advances its step counter by
    ``block.k`` per yielded block (``step`` passed in is the block's FIRST
    step; after dispatch the block's last step is ``step + block.k - 1``)."""

    def __init__(self, loader, k_dispatch: int, max_steps: int):
        self.loader = loader
        self.k_dispatch = k_dispatch
        self.max_steps = max_steps
        self.fuse_gather = getattr(loader, "supports_indexed", False)

    def next_block(self, step: int) -> Block:
        k = block_size(step, self.k_dispatch, self.max_steps, self.loader)
        if k > 1:
            pairs = [self.loader.next_indices() for _ in range(k)]
            return Block(
                "block", k, self.loader,
                idx_block=np.stack([p[0] for p in pairs]),
                idx=pairs[-1][0],  # eval-time aug-preview materialization
                labels_block=[np.asarray(p[1]) for p in pairs])
        if self.fuse_gather:
            idx, labels = self.loader.next_indices()
            return Block("indexed", 1, self.loader, idx=idx, labels=labels)
        batch, labels = next(self.loader)  # already on the device
        return Block("batch", 1, self.loader, batch=batch, labels=labels)
