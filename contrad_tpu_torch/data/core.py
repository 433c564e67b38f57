"""Dataset container and the train CLIs' data paths (the port of
``contrad_tpu/data/core.py``).

Three paths feed the train step, as in the JAX package, and
:func:`make_train_loader` chooses between them by the set's size:

  * :class:`DeviceBatchIterator`: the whole uint8 set on every card; each
    step gathers its batch there from an index vector, so no pixels cross
    the host link after set-up, and a block of steps can be captured in CUDA
    graphs (``training/graph.py``).
  * :class:`ShardedDeviceBatchIterator`: in a world of processes, each rank
    holds one chunk of the set on its card and draws its rows of the global
    batch from it; at every epoch boundary the chunks move one rank round
    the ring (``parallel.ring_shift_``), in place.
  * :class:`PrefetchIterator` over :class:`BatchIterator`: the host-fed
    stream. A worker thread gathers each batch on the host (the native
    gather, ``data/native.py``) into pinned memory and copies it to the card
    on a side stream while the step before runs.

Every path draws the JAX package's rows: a seeded reshuffle per epoch
(``numpy.random.default_rng((seed, epoch))``) and drop-last, or, sharded,
JAX's staging permutation and per-device orders. Each has a ``state_dict``
(its epoch and position), so a resumed run reads the batches an
uninterrupted run would have read.

In a world of processes (``shard=(rank, world)``) every rank draws the same
global permutation and takes its rows of each global batch. The JAX package
slices the flat ``n_critic x B`` batch contiguously and XLA reshards it;
here each rank computes its own rows of every critic sub-batch, so each of
the ``parts`` sub-batches is sliced (``parts = n_critic``). The global
batch is the same rows in the same order, and the position, kept in global
rows, is the same on every rank: a checkpoint of a world resumes in a world
of any size. The sharded path keeps JAX's rows too (rank r draws JAX device
r's), grouped into critic sub-batches the port's way (see
:class:`ShardedDeviceBatchIterator`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from contrad_tpu_torch import resolve_device
from contrad_tpu_torch.data import native
from contrad_tpu_torch.parallel.mesh import local_rows

Shard = Optional[Tuple[int, int]]


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


class BatchIterator:
    """Infinite stream of shuffled uint8 batches gathered on the host: the
    JAX package's ``BatchIterator``, and the one place the epoch
    bookkeeping of the unsharded paths lives (:class:`DeviceBatchIterator`
    consumes its :meth:`next_indices`).

    ``batch_size`` is the global rows of one step (``n_critic`` sub-batches
    of ``batch_size / parts``); with ``shard=(rank, world)`` a batch is
    this rank's rows of each of the ``parts`` sub-batches. ``next(it)``
    gives ``(images, labels)`` as numpy arrays; :meth:`next_batch` can
    gather into a buffer of the caller's (a pinned one)."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, seed: int = 0,
                 start_epoch: int = 0, shard: Shard = None, parts: int = 1):
        if batch_size > len(dataset):
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {len(dataset)}")
        self.shard = shard if shard is not None and shard[1] > 1 else None
        world = 1
        if self.shard is not None:
            rank, world = self.shard
            if batch_size % (parts * world):
                raise ValueError(
                    f"global batch {batch_size // parts} must divide device "
                    f"count {world}")
            if not 0 <= rank < world:
                raise ValueError(f"bad shard {shard}")
        self.dataset = dataset
        self.parts = parts
        self.batch_size = batch_size  # the GLOBAL rows of one step
        self.rows = batch_size // world  # this rank's rows of one step
        self.seed = seed
        self.epoch = start_epoch
        self.n = len(dataset)
        self._labels = np.asarray(dataset.labels, np.int64)
        self._order = None
        self._pos = 0

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos,
                "started": self._order is not None}

    def load_state_dict(self, state: dict) -> None:
        """Continue from ``state``: the epoch's permutation and the next
        batch's first row."""
        if "sharded_world" in state:
            raise ValueError("a sharded stream's position does not resume an "
                             "unsharded stream")
        self.epoch, self._pos = int(state["epoch"]), int(state["pos"])
        self._order = (np.random.default_rng((self.seed, self.epoch))
                       .permutation(self.n) if state["started"] else None)

    def __iter__(self):
        return self

    def next_indices(self) -> np.ndarray:
        """Advance the stream by one batch and return its dataset rows (in a
        world, this rank's rows of each of the ``parts`` sub-batches)."""
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
        return idx

    def next_batch(self, out: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The next batch's images (gathered into ``out`` where given) and
        int64 labels."""
        idx = self.next_indices()
        return (native.gather_batch(self.dataset.images, idx, out=out),
                self._labels[idx])

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.next_batch()


class PrefetchIterator:
    """The host-fed stream on the device: ``(images, labels)`` batches of
    the :class:`BatchIterator` ``it``, gathered and copied by a worker
    thread up to ``depth`` batches ahead of the consumer (the JAX package's
    ``PrefetchIterator``, the reference's DataLoader worker with
    ``pin_memory``).

    On the card the worker gathers each batch into one of a ring of
    ``depth + 1`` pinned host buffers (a buffer is refilled only after its
    previous copy has finished) and copies it to the card on a side CUDA
    stream with ``non_blocking=True``, recording an event after the copy.
    ``next()`` makes the consuming stream wait on that event and marks the
    batch's memory as used by that stream, so the copy overlaps the step
    before and the step never reads a batch still in flight. On the CPU the
    worker hands over the gathered arrays as tensors.

    The worker starts at the first ``next()``. ``state_dict()`` is the
    consumer's position: the inner stream's state recorded with the last
    batch handed out, not the worker's, which runs ahead. ``close()`` (and
    ``load_state_dict``) stop the worker and rewind the inner stream to that
    position, so a later ``next()`` goes on where the consumer stopped. An
    error in the worker is raised by the ``next()`` that would have taken
    its batch.

    ``stats``: batches handed out, the worker's seconds gathering on the
    host, the copies' device milliseconds (of ``copies_timed`` copies, each
    read when its buffer is reused), and the consumer's seconds waiting for
    a batch."""

    supports_indexed = False
    path = "host-fed"

    def __init__(self, it: BatchIterator, device: str | torch.device = "cuda",
                 depth: int = 2):
        self._it = it
        self.device = resolve_device(device)
        # at start-up, so that a failed build raises here and the first
        # batch does not wait for g++
        native.build()
        self.depth = depth
        self._state = it.state_dict()
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._ring = None  # [pinned images, pinned labels, last copy events]
        self._slot = 0
        self._stream = None
        self.stats = {"batches": 0, "gather_s": 0.0, "copy_ms": 0.0,
                      "copies_timed": 0, "wait_s": 0.0}

    def __iter__(self):
        return self

    # ------------------------------------------------------------ worker

    def _produce(self):
        """Gather the next batch and start its copy to the device."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            images, labels = self._it.next_batch()
            self.stats["gather_s"] += time.perf_counter() - t0
            return (torch.from_numpy(images), torch.from_numpy(labels), None,
                    self._it.state_dict())
        if self._ring is None:
            shape = (self._it.rows,) + tuple(self._it.dataset.image_size)
            self._ring = [[torch.empty(shape, dtype=torch.uint8,
                                       pin_memory=True),
                           torch.empty(self._it.rows, dtype=torch.int64,
                                       pin_memory=True), None]
                          for _ in range(self.depth + 1)]
            self._stream = torch.cuda.Stream(self.device)
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        if slot[2] is not None:  # this buffer's previous copy
            slot[2][1].synchronize()
            self.stats["copy_ms"] += slot[2][0].elapsed_time(slot[2][1])
            self.stats["copies_timed"] += 1
        t0 = time.perf_counter()
        _, labels = self._it.next_batch(out=slot[0].numpy())
        slot[1].numpy()[:] = labels
        self.stats["gather_s"] += time.perf_counter() - t0
        state = self._it.state_dict()
        start, done = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self._stream):
            start.record()
            images = slot[0].to(self.device, non_blocking=True)
            labels = slot[1].to(self.device, non_blocking=True)
            done.record()
        slot[2] = (start, done)
        return images, labels, done, state

    def _work(self, q: queue.Queue, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                payload = self._produce()
            except BaseException as e:  # noqa: BLE001 (handed to the consumer)
                payload = e
            # a timed put, so that a worker blocked on a full queue sees stop
            while not stop.is_set():
                try:
                    q.put(payload, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(payload, BaseException):
                return

    def _start(self) -> None:
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work,
                                        args=(self._q, self._stop),
                                        daemon=True)
        self._thread.start()

    def _stop_worker(self, timeout: float) -> None:
        if self._thread is None:
            return
        self._stop.set()
        try:  # a worker blocked on put wakes up and sees stop
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("the prefetch worker did not stop")
        self._thread = None
        self._it.load_state_dict(self._state)

    # ---------------------------------------------------------- consumer

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._thread is None:
            self._start()
        t0 = time.perf_counter()
        item = self._q.get()
        self.stats["wait_s"] += time.perf_counter() - t0
        if isinstance(item, BaseException):
            self._thread.join()
            self._thread = None
            self._it.load_state_dict(self._state)
            raise item
        images, labels, done, state = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            images.record_stream(stream)
            labels.record_stream(stream)
        self._state = state
        self.stats["batches"] += 1
        return images, labels

    def state_dict(self) -> dict:
        return dict(self._state)

    def load_state_dict(self, state: dict) -> None:
        self._stop_worker(timeout=10.0)
        self._it.load_state_dict(state)
        self._state = self._it.state_dict()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker thread; the inner stream goes back to the
        consumer's position."""
        self._stop_worker(timeout)


class DeviceBatchIterator:
    """Infinite stream of shuffled uint8 NHWC batches gathered on the device
    (with ``with_labels``, ``(images, labels)`` pairs) from the whole set
    copied to the device once. Like the JAX package's device-resident loader
    it also hands out index vectors (``next_indices``) that a caller gathers
    itself (``materialize``): a block of steps moves only its index vectors
    to the device. Its rows are :class:`BatchIterator`'s.

    ``MAX_BYTES`` is the largest set it takes. The JAX package's 2 GB was
    sized for a 16 GB TPU v5e; the H100 has 80 GB. The largest peak of a
    train step measured on one (the 512x512 recipe's float32 graph step at
    batch 16, 29.1 GiB, ``chip_smoke.py`` phase 11) beside 16 GiB of data
    leaves over 30 GiB of the card free. Every set of the registry fits
    (CIFAR about 150 MB, celeba128 1.5 GB, AFHQ-dog 3.7 GB), so every
    recipe keeps the device-resident path; :func:`make_train_loader` shards
    or streams a larger set."""

    MAX_BYTES = 16 * 2**30

    # the rows an index vector names are rows of ``images``, the whole set
    supports_indexed = True
    local_indexing = False
    path = "device-resident"

    def __init__(self, dataset: ArrayDataset, batch_size: int, seed: int = 0,
                 start_epoch: int = 0, device: str | torch.device = "cuda",
                 with_labels: bool = False, shard: Shard = None,
                 parts: int = 1):
        if dataset.images.nbytes > self.MAX_BYTES:
            raise ValueError(
                f"dataset too large for device residency "
                f"({dataset.images.nbytes >> 20} MB > MAX_BYTES "
                f"{self.MAX_BYTES >> 20} MB); make_train_loader shards or "
                f"streams it")
        self._indices = BatchIterator(dataset, batch_size, seed, start_epoch,
                                      shard, parts)
        self.device = resolve_device(device)
        self.with_labels = with_labels
        self._labels = self._indices._labels
        self.images = torch.from_numpy(np.ascontiguousarray(dataset.images)).to(
            self.device)

    @property
    def epoch(self) -> int:
        return self._indices.epoch

    @property
    def batch_size(self) -> int:
        return self._indices.batch_size

    @property
    def shard(self) -> Shard:
        return self._indices.shard

    def state_dict(self) -> dict:
        return self._indices.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._indices.load_state_dict(state)

    def next_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the stream by one batch and return its dataset rows
        (int32) and their labels, both on the host: in a world, this rank's
        rows of each of the ``parts`` sub-batches."""
        idx = self._indices.next_indices()
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


class ShardPlan:
    """The host side of a sharded set (JAX's ``ShardedDeviceBatchIterator``
    bookkeeping, ``core.py:183-242``): the staging permutation
    ``default_rng((seed, 0xD5))`` truncated to a multiple of ``world`` and
    cut into ``world`` chunks of ``shard_len`` rows (``chunks[c]``, the
    dataset rows of chunk c), each rank's ``local_batch`` rows a step, the
    chunk a rank holds after an epoch's rotations and its order in an
    epoch."""

    def __init__(self, n: int, batch_size: int, world: int, seed: int):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} must be divisible "
                             f"by the device count {world}")
        self.world, self.seed = world, seed
        self.local_batch = batch_size // world
        kept = n - n % world
        self.shard_len = kept // world
        if self.local_batch > self.shard_len:
            raise ValueError(
                f"per-device batch {self.local_batch} exceeds per-device "
                f"shard {self.shard_len}")
        perm = np.random.default_rng((seed, 0xD5)).permutation(n)[:kept]
        self.chunks = perm.reshape(world, self.shard_len)

    def chunk_of(self, rank: int, epoch: int) -> int:
        """The chunk ``rank`` holds after ``epoch`` ring rotations."""
        return (rank - epoch) % self.world

    def order(self, epoch: int, rank: int) -> np.ndarray:
        """``rank``'s order over its shard in ``epoch``."""
        return np.random.default_rng((self.seed, epoch, rank)).permutation(
            self.shard_len)


class ShardedDeviceBatchIterator:
    """A set sharded over the ranks of a world, one chunk on each card (the
    JAX package's ``ShardedDeviceBatchIterator``, whose chunks live on a
    mesh's devices): ``world`` times the set that one card's ``MAX_BYTES``
    keeps resident.

    Rank r holds chunk r of the staging permutation (:class:`ShardPlan`)
    and draws ``local_batch = batch_size / world`` rows a step from it, in
    its order of the epoch: JAX device r's rows. An index vector names rows
    of this rank's ``images`` (``local_indexing``), labels stay on the
    host, per chunk. At every epoch boundary the chunks move one rank round
    the ring (``parallel.ring_shift_``: rank r then holds what rank r - 1
    held) **in place**: a CUDA graph captured on ``images`` reads the new
    chunk. ``steps_until_rotation`` keeps a block of graph replays inside an
    epoch (``training/dispatch.py::block_size``).

    The global batch is JAX's, row for row, where it is one sub-batch (the
    flagship's and the 512x512 recipe's ``n_critic = 1``). With ``n_critic >
    1`` rank r still draws JAX device r's rows, and the trainer splits them
    into ``n_critic`` parts in order; critic sub-batch j is then every
    rank's part j, in rank order: the rows of JAX's global batch, grouped
    otherwise (JAX's sub-batch j is rows ``[jB, (j+1)B)`` of its global
    batch). The port's world takes each rank's rows of every sub-batch
    (``parallel/mesh.py::local_rows``), which asks for this grouping."""

    supports_indexed = True
    local_indexing = True
    path = "sharded"

    def __init__(self, dataset: ArrayDataset, batch_size: int, seed: int = 0,
                 device: str | torch.device = "cuda",
                 with_labels: bool = False, shard: Shard = None):
        from contrad_tpu_torch.parallel import data_shard

        self.rank, self.world = data_shard() if shard is None else shard
        self.plan = ShardPlan(len(dataset), batch_size, self.world, seed)
        self.batch_size = batch_size
        self.local_batch = self.plan.local_batch
        self.shard_len = self.plan.shard_len
        self.seed = seed
        self.epoch = 0
        self.device = resolve_device(device)
        self.with_labels = with_labels
        labels = np.asarray(dataset.labels, np.int64)
        self._label_chunks = labels[self.plan.chunks]
        self.images = torch.from_numpy(native.gather_batch(
            dataset.images, self.plan.chunks[self.rank])).to(self.device)
        self._rotations = 0  # ring shifts applied to ``images``
        self._order = None
        self._pos = 0

    def _chunk(self) -> int:
        return self.plan.chunk_of(self.rank, self.epoch)

    def _rotate_to_epoch(self) -> None:
        """Shift the chunks round the ring until ``images`` holds this
        epoch's chunk (the shift has period ``world``)."""
        from contrad_tpu_torch.parallel import data_shard, ring_shift_

        while (self.epoch - self._rotations) % self.world:
            if data_shard() != (self.rank, self.world):
                raise RuntimeError(f"a shard of {(self.rank, self.world)} "
                                   f"rotates only in its world, not in "
                                   f"{data_shard()}")
            ring_shift_(self.images)
            self._rotations += 1

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos,
                "started": self._order is not None,
                "sharded_world": self.world}

    def load_state_dict(self, state: dict) -> None:
        """Continue from ``state`` (a stream of a world of the same size):
        the chunks rotated to its epoch (the ranks shift together: every
        rank loads the same state), the epoch's order and position."""
        if state.get("sharded_world") != self.world:
            raise ValueError(f"a sharded stream of a world of {self.world} "
                             f"cannot resume {state}")
        self.epoch, self._pos = int(state["epoch"]), int(state["pos"])
        self._rotate_to_epoch()
        self._order = (self.plan.order(self.epoch, self.rank)
                       if state["started"] else None)

    def steps_until_rotation(self) -> int:
        """Batches left before the next epoch boundary's rotation (0 before
        the first batch)."""
        if self._order is None:
            return 0
        return (self.shard_len - self._pos) // self.local_batch

    def next_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the stream by one batch (rotating at an epoch boundary)
        and return this rank's index vector into ``images`` (int32) and its
        labels, on the host."""
        if (self._order is None
                or self._pos + self.local_batch > self.shard_len):
            if self._order is not None:
                self.epoch += 1
                self._rotate_to_epoch()
            self._order = self.plan.order(self.epoch, self.rank)
            self._pos = 0
        idx = self._order[self._pos: self._pos + self.local_batch]
        self._pos += self.local_batch
        return idx.astype(np.int32), self._label_chunks[self._chunk()][idx]

    def dataset_rows(self, idx) -> np.ndarray:
        """The dataset rows that index vector ``idx`` names in this
        epoch."""
        return self.plan.chunks[self._chunk()][np.asarray(idx)]

    def materialize(self, idx) -> torch.Tensor:
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
                      with_labels: bool = False, shard: Shard = None):
    """The train CLIs' data stream (JAX's ``make_train_loader``, with the
    world's ranks in place of a mesh's devices): ``n_critic`` sub-batches
    of the global ``batch_size`` a step, in a world this rank's rows of each
    (``shard`` is ``parallel.data_shard()`` where None). By the set's size:

      * at most ``DeviceBatchIterator.MAX_BYTES``: the whole set on each
        card (:class:`DeviceBatchIterator`);
      * else, in a world of more than one, at most ``MAX_BYTES x world``:
        one chunk on each card (:class:`ShardedDeviceBatchIterator`);
      * else host-fed: :class:`PrefetchIterator` over
        :class:`BatchIterator`.

    JAX streams from the host in every multi-process world
    (``core.py:379-383``); the port keeps the whole set on each card while
    it fits, which keeps the step's CUDA graphs."""
    from contrad_tpu_torch.parallel import data_shard

    shard = data_shard() if shard is None else shard
    rows = batch_size * n_critic
    nbytes = dataset.images.nbytes
    if nbytes <= DeviceBatchIterator.MAX_BYTES:
        return DeviceBatchIterator(dataset, rows, seed=seed, device=device,
                                   with_labels=with_labels, shard=shard,
                                   parts=n_critic)
    if shard[1] > 1 and nbytes <= DeviceBatchIterator.MAX_BYTES * shard[1]:
        return ShardedDeviceBatchIterator(dataset, rows, seed=seed,
                                          device=device,
                                          with_labels=with_labels,
                                          shard=shard)
    return PrefetchIterator(BatchIterator(dataset, rows, seed=seed,
                                          shard=shard, parts=n_critic),
                            device=device)
