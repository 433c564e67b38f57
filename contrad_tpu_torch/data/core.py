"""Dataset container and the device-resident batch stream (the port of
``contrad_tpu/data/core.py``: ``ArrayDataset``, ``BatchIterator``'s epoch
bookkeeping and ``DeviceBatchIterator``).

The whole uint8 train set is copied to the device once; each step gathers
its batch there from an index vector, so no pixels cross the host link
after set-up. Epoch semantics match the JAX package: a seeded reshuffle per
epoch (``numpy.random.default_rng((seed, epoch))``) and drop-last. With
``with_labels`` the stream yields ``(images, labels)``, the batch's int64
labels copied to the device beside it. Its position (epoch and row) is a
``state_dict``, so a resumed run reads the batches an uninterrupted run
would have read.

In a world of processes (``shard=(rank, world)``, the counterpart of the
JAX ``BatchIterator``'s) every rank keeps the whole set on its card, draws
the same global permutation and takes its rows of each global batch. The
JAX package slices the flat ``n_critic x B`` batch contiguously and XLA
reshards it; here each rank computes its own rows of every critic
sub-batch, so each of the ``parts`` sub-batches is sliced (``parts =
n_critic``). The global batch is the same rows in the same order, and the
position, kept in global rows, is the same on every rank: a checkpoint of a
world resumes in a world of any size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from contrad_tpu_torch import resolve_device
from contrad_tpu_torch.parallel.mesh import local_rows


@dataclasses.dataclass
class ArrayDataset:
    """uint8 NHWC images (+ int labels) in host memory."""

    images: np.ndarray  # (N, H, W, C) uint8
    labels: Optional[np.ndarray] = None  # (N,) int64
    train_aug: str = "none"  # augmentation the reference baked into transforms
    n_classes: int = 1

    def __post_init__(self):
        if self.images.dtype != np.uint8:
            raise TypeError("datasets carry uint8 images")
        if self.labels is None:
            self.labels = np.zeros((len(self.images),), dtype=np.int64)

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_size(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])


class DeviceBatchIterator:
    """Infinite stream of shuffled uint8 NHWC batches gathered on the device
    (with ``with_labels``, ``(images, labels)`` pairs). Like the JAX
    package's device-resident loader it also hands out index vectors
    (``next_indices``) that a caller gathers itself (``materialize``): a
    block of steps moves only its index vectors to the device."""

    # the rows an index vector names are rows of ``images``, the whole set
    supports_indexed = True
    local_indexing = False

    def __init__(self, dataset: ArrayDataset, batch_size: int, seed: int = 0,
                 start_epoch: int = 0, device: str | torch.device = "cuda",
                 with_labels: bool = False,
                 shard: Optional[Tuple[int, int]] = None, parts: int = 1):
        if batch_size > len(dataset):
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {len(dataset)}")
        self.shard = shard if shard is not None and shard[1] > 1 else None
        if self.shard is not None:
            rank, world = self.shard
            if batch_size % (parts * world):
                raise ValueError(
                    f"global batch {batch_size // parts} must divide device "
                    f"count {world}")
            if not 0 <= rank < world:
                raise ValueError(f"bad shard {shard}")
        self.parts = parts
        self.device = resolve_device(device)
        self.batch_size = batch_size  # the GLOBAL rows of one step
        self.seed = seed
        self.epoch = start_epoch
        self.n = len(dataset)
        self._order = None
        self._pos = 0
        self.with_labels = with_labels
        self._labels = np.asarray(dataset.labels, np.int64)
        self.images = torch.from_numpy(np.ascontiguousarray(dataset.images)).to(
            self.device)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos,
                "started": self._order is not None}

    def load_state_dict(self, state: dict) -> None:
        """Continue from ``state``: the epoch's permutation and the next
        batch's first row."""
        self.epoch, self._pos = int(state["epoch"]), int(state["pos"])
        self._order = (np.random.default_rng((self.seed, self.epoch))
                       .permutation(self.n) if state["started"] else None)

    def next_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the stream by one batch and return its dataset rows
        (int32) and their labels, both on the host: in a world, this rank's
        rows of each of the ``parts`` sub-batches."""
        if self._order is None or self._pos + self.batch_size > self.n:
            if self._order is not None:
                self.epoch += 1
            rng = np.random.default_rng((self.seed, self.epoch))
            self._order = rng.permutation(self.n)
            self._pos = 0
        idx = self._order[self._pos: self._pos + self.batch_size]
        self._pos += self.batch_size
        if self.shard is not None:
            idx = local_rows(idx, self.batch_size // self.parts, self.shard)
        return idx.astype(np.int32), self._labels[idx]

    def materialize(self, idx) -> torch.Tensor:
        """The images of rows ``idx`` (host or device), gathered on the
        device."""
        idx = torch.as_tensor(idx).to(self.device, torch.int64,
                                      non_blocking=True)
        return self.images.index_select(0, idx)

    def __iter__(self):
        return self

    def __next__(self):
        idx, labels = self.next_indices()
        images = self.materialize(idx)
        if not self.with_labels:
            return images
        return images, torch.from_numpy(labels).to(self.device)


def make_train_loader(dataset: ArrayDataset, batch_size: int, n_critic: int,
                      seed: int = 0, device: str | torch.device = "cuda",
                      with_labels: bool = False) -> DeviceBatchIterator:
    """The train CLIs' data stream (the counterpart of the JAX
    ``make_train_loader``): ``n_critic`` sub-batches of the global
    ``batch_size`` a step, gathered on the card from the device-resident
    set; in a world of processes, this rank's rows of each (``parallel.
    data_shard``)."""
    from contrad_tpu_torch.parallel import data_shard

    return DeviceBatchIterator(dataset, batch_size * n_critic, seed=seed,
                               device=device, with_labels=with_labels,
                               shard=data_shard(), parts=n_critic)
