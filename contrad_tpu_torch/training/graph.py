"""The execution half of multi-step dispatch (``training/dispatch.py`` sizes
the blocks): a block of K train steps, run as CUDA graph replays on the card
and as K eager steps on the CPU. It is how the port runs the JAX CLIs'
``--steps_per_dispatch``, whose block is one jitted ``lax.scan`` of K steps
(``GANTrainer.train_steps_indexed``, ``contrad_tpu/training/step.py:370``).

On the card, one graph per step kind: ``plain``, and ``r1`` for a StyleGAN2
step with the lazy R1 penalty. Both are captured in one shared memory pool,
each at the first step that needs it, and a block is the sequence of replays
its steps' kinds ask for (JAX's ``r1_block`` vector). A graph of one step,
not of K, so that any pattern of R1 steps inside a block replays without a
capture of its own.

  * **Static inputs.** The graphs read a step's index vector (and, for a
    conditional D, its labels) and the EMA decay from one device row. A
    block's rows go to the device in one copy from pinned host memory, with
    two buffers in turn, each reused only after its previous copy has
    finished; before each replay a device-to-device copy puts the step's
    row in place. Nothing waits for the card between the replays of a
    block.
  * **State.** Everything a step changes is changed in place (parameters,
    Adam's moments and its device-side count, spectral norm's ``u``,
    the batch-norm statistics, the EMA) and every draw comes from the
    trainer's device generator, which each graph registers, so that a replay
    advances it as the eager step would.
  * **Warm-up.** Before a capture, ``WARMUP_STEPS`` eager steps of the kind
    run on a side stream (first-use allocations, library handles and
    cached constants happen there, not under capture), from a snapshot of
    the whole trainer state (``state_dict``: G, D, EMA, ``u``, batch-norm
    statistics, Adam's moments and count, the generator), which is then
    restored bitwise: warm-up trains nothing. Their kernel launches are
    real and counted.
  * **Counts.** A capture launches nothing: the launches of the blur and of
    the fused activation it recorded are taken off their counters
    (``blur2d.launches``, ``fused_leaky_relu.launches`` and their
    ``scalar_launches``) and added back at each replay, as are the
    collectives of a world (``parallel.collectives.counts``), and the
    optimisers' host counts advance by each replay's updates (the device
    counts advance inside the graph).
  * **Worlds.** Under NCCL a step's collectives (the gathers of the global
    losses, the batch-norm statistics, the gradient all-reduce) are captured
    inside its graph; the communicator exists before (``init_distributed``
    runs one collective) and the warm-up steps run them eagerly. Gloo cannot
    be captured: a gloo world runs the eager step (``utils/run.py``).
  * **No fallback.** A capture or a replay that fails raises; a block never
    quietly runs eager on the card.
  * **Spans.** While a profiler runs, the host's work is spanned
    (``utils/trace.py``): ``contrad.block.stage`` (packing a block's rows,
    their pinned copy and the wait for the buffer's previous copy),
    ``contrad.block.replay`` around each replay, and
    ``contrad.graph.warmup`` and ``contrad.graph.capture``, each with the
    step's ``kind``. The step's own phases are marked on the device inside
    the graphs.

A block of one step (a tail, a misaligned step, ``K = 1``), and every block
on the CPU, runs eagerly through the same code: the plain version that the
CPU tests hold the graphs' semantics to.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from contrad_tpu_torch.ops import blur, fused_act
from contrad_tpu_torch.parallel import collectives
from contrad_tpu_torch.training.step import Metrics, StyleGAN2Trainer
from contrad_tpu_torch.utils.trace import span

WARMUP_STEPS = 2  # eager steps of a kind before its capture
# the hand-written kernels' wrappers, whose launch counters a replay advances
COUNTED = (blur.blur2d, fused_act.fused_leaky_relu)


def _launch_counts():
    return [(op.launches, op.scalar_launches) for op in COUNTED]


def _clone(tree):
    """A deep copy of a state dict's tensors (CPU tensors stay on the CPU)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


class _Captured:
    """One step kind's graph, its static outputs (the step's metrics), the
    launches it holds of each ``COUNTED`` kernel (all, scalar path) and each
    optimiser's updates in one replay."""

    def __init__(self, graph, outputs: Metrics, counts, updates: Sequence[int],
                 collectives: Dict[str, int]):
        self.graph, self.outputs = graph, outputs
        self.counts, self.updates = counts, updates
        self.collectives = collectives


class BlockRunner:
    """Runs the blocks of :class:`~contrad_tpu_torch.training.dispatch.
    BlockDispatcher` on ``trainer`` (a ``GANTrainer`` or
    ``StyleGAN2Trainer``) with images from ``loader`` (its ``images`` on the
    device and ``materialize``), or with batches a host-fed loader put on
    the device. ``graphs`` turns on the CUDA graphs of blocks of more than
    one step of index vectors, on the card only."""

    def __init__(self, trainer, loader, graphs: bool = True):
        self.trainer, self.loader = trainer, loader
        self.device = trainer.device
        self.graphs = graphs and self.device.type == "cuda"
        self._captured: Dict[str, _Captured] = {}
        self._pool = None
        self._buffers = None
        self._slot = 0
        self._setup_seconds = 0.0
        self.stats: Dict[str, Any] = dict(
            capture_seconds={}, captured_launches={}, replays={},
            replay_launches=0, captured_collectives={})

    # ------------------------------------------------------------- blocks

    def run(self, idx_block: Optional[Sequence[np.ndarray]],
            labels_block: Optional[Sequence[np.ndarray]] = None,
            ema_decay: Optional[Sequence[float]] = None,
            do_r1: Optional[Sequence[bool]] = None,
            batches: Optional[Sequence[torch.Tensor]] = None) -> Metrics:
        """The block's steps, one index vector (and label vector, for a
        conditional D) per step, with each step's EMA decay and lazy-R1
        flag (0 and False where None); returns the last step's metrics,
        still on the device. ``batches``, where given in place of the index
        vectors (``idx_block`` None), are the steps' images already on the
        device (a host-fed loader's ``"batch"`` block), run eagerly."""
        if (idx_block is None) == (batches is None):
            raise ValueError("a block takes index vectors or batches")
        k = len(idx_block if batches is None else batches)
        ema = [0.0] * k if ema_decay is None else [float(e) for e in ema_decay]
        r1 = [False] * k if do_r1 is None else [bool(r) for r in do_r1]
        if self.graphs and k > 1 and batches is None:
            return self._replay(idx_block, labels_block, ema, r1)
        for i in range(k):
            labels = (None if labels_block is None else torch.as_tensor(
                labels_block[i], dtype=torch.int64, device=self.device))
            images = (self.loader.materialize(idx_block[i]) if batches is None
                      else batches[i])
            metrics = self.trainer.train_step(
                images, ema_decay=ema[i], **self._step_kwargs(r1[i], labels))
        return metrics

    def take_setup_seconds(self) -> float:
        """Seconds spent warming up and capturing since the last call (the
        CLIs keep them out of the step time, as they keep evaluations)."""
        s, self._setup_seconds = self._setup_seconds, 0.0
        return s

    def _step_kwargs(self, do_r1: bool, labels) -> Dict[str, Any]:
        kw = {}
        if isinstance(self.trainer, StyleGAN2Trainer):
            kw["do_r1"] = do_r1
        elif do_r1:
            raise ValueError("only the StyleGAN2 trainer has a lazy R1 step")
        if self.trainer.conditional:
            kw["labels"] = labels
        return kw

    # ------------------------------------------------------------- graphs

    def _layout(self, batch: int) -> None:
        """The static row, one int64 vector on the device: the index vector,
        the labels (conditional D) and, in the last slot, the float32 EMA
        decay."""
        n = batch * (2 if self.trainer.conditional else 1) + 1
        self._row = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._idx = self._row[:batch]
        self._labels = (self._row[batch:2 * batch]
                        if self.trainer.conditional else None)
        self._ema = self._row[-1:].view(torch.float32)[0]

    def _pack(self, idx_block, labels_block, ema) -> np.ndarray:
        """The (k, row length) int64 host rows of a block."""
        parts = [np.stack(idx_block).astype(np.int64)]
        if self.trainer.conditional:
            parts.append(np.stack(labels_block).astype(np.int64))
        decay = np.zeros((len(ema), 2), np.float32)
        decay[:, 0] = ema
        return np.concatenate(parts + [decay.view(np.int64)], axis=1)

    def _replay(self, idx_block, labels_block, ema, r1) -> Metrics:
        k = len(idx_block)
        if self._buffers is None:
            self._layout(len(idx_block[0]))
            shape = (k,) + tuple(self._row.shape)
            self._buffers = [(
                torch.empty(shape, dtype=torch.int64, pin_memory=True),
                torch.empty(shape, dtype=torch.int64, device=self.device),
                torch.cuda.Event()) for _ in range(2)]
        pinned, staged, copied = self._buffers[self._slot]
        self._slot ^= 1
        with span("contrad.block.stage"):
            copied.synchronize()  # this buffer's previous copy has finished
            pinned[:k].copy_(torch.from_numpy(
                self._pack(idx_block, labels_block, ema)))
            staged[:k].copy_(pinned[:k], non_blocking=True)
            copied.record()
        for i in range(k):
            kind = "r1" if r1[i] else "plain"
            self._row.copy_(staged[i])
            if kind not in self._captured:
                self._capture(kind)
            entry = self._captured[kind]
            with span("contrad.block.replay", kind=kind):
                entry.graph.replay()
            for op, (n, scalar) in zip(COUNTED, entry.counts):
                op.launches += n
                op.scalar_launches += scalar
            for key, n in entry.collectives.items():
                collectives.counts[key] += n
            for opt, n in zip(self._optimizers(), entry.updates):
                opt.count += n
            self.stats["replays"][kind] = self.stats["replays"].get(kind, 0) + 1
            self.stats["replay_launches"] += entry.counts[0][0]
        return {name: v.clone() for name, v in entry.outputs.items()}

    def _optimizers(self):
        return (self.trainer.g_tx, self.trainer.d_tx)

    def _graph_step(self, kind: str) -> Metrics:
        """One step of ``kind`` on the static row's inputs."""
        images = self.loader.images.index_select(0, self._idx)
        return self.trainer.train_step(
            images, ema_decay=self._ema,
            **self._step_kwargs(kind == "r1", self._labels))

    def _capture(self, kind: str) -> None:
        """Warm up ``kind`` from a snapshot of the trainer, restore it, and
        capture one step of it on the static row (see the module
        docstring)."""
        trainer = self.trainer
        torch.cuda.synchronize()  # the block's earlier replays are not setup
        t0 = time.perf_counter()
        snapshot = _clone(trainer.state_dict())
        counts = [opt.count for opt in self._optimizers()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with span("contrad.graph.warmup", kind=kind), \
                torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._graph_step(kind)
        torch.cuda.current_stream().wait_stream(side)
        updates = [(opt.count - c) // WARMUP_STEPS
                   for opt, c in zip(self._optimizers(), counts)]
        trainer.load_state_dict(snapshot)
        del snapshot
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(trainer.rng.device)
        launched = _launch_counts()
        before = dict(collectives.counts)
        with span("contrad.graph.capture", kind=kind), torch.cuda.graph(
                graph, pool=self._pool):
            outputs = self._graph_step(kind)
        captured = [(n - n0, s - s0) for (n, s), (n0, s0)
                    in zip(_launch_counts(), launched)]
        for op, (n0, s0) in zip(COUNTED, launched):
            op.launches, op.scalar_launches = n0, s0
        held = {k: collectives.counts[k] - v for k, v in before.items()}
        collectives.counts.update(before)
        if self._pool is None:
            self._pool = graph.pool()
        self._captured[kind] = _Captured(graph, outputs, captured, updates,
                                         held)
        seconds = time.perf_counter() - t0
        self._setup_seconds += seconds
        self.stats["capture_seconds"][kind] = seconds
        self.stats["captured_launches"][kind] = captured[0][0]
        self.stats["captured_collectives"][kind] = held
