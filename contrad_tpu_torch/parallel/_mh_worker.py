"""One process of a world of train processes, for the tests and
``chip_smoke.py`` (the counterpart of ``contrad_tpu/parallel/_mh_worker.py``).

It runs a few train steps as one rank of a world (``--world`` > 1: the
``CONTRAD_*`` rendezvous on ``--port``, gloo on the CPU, NCCL on the card or
gloo there where the spawner sets ``CONTRAD_BACKEND=gloo``) or, with ``--world 1``, the same steps
in one process without a world: the oracle a world is held to. Each rank
writes what it computed to ``<--out>.rank<r>.pt``: the metrics of every
step, the gradients the optimisers were given at the first step (after the
world's all-reduce), the whole trainer state at the end (parameters,
spectral norm's ``u``, batch-norm statistics, EMA G, Adam's moments and
counts, the generator's state), the blur's launches and the collectives'
calls, bytes and seconds of each step, and each step's milliseconds.

Two kinds of run:

* a recipe, drawn by the port itself, with Adam and the loader that
  ``make_train_loader`` chooses over synthetic data (the JAX worker's
  three: the default SNDCGAN ``contrad``, ``--conditional``, and
  ``--trainer sg2``, StyleGAN2 with EMA after an EMA-start step and the
  lazy R1 every ``--d_reg_every`` steps), at the JAX worker's widths
  (SNDCGAN ngf = ndf = 8, nz = 16, d_hidden = 32; ``stylegan2_tiny``) or at
  any architecture of the registry (``--arch``). ``--max_bytes`` moves the
  loader's limit, so that a world shards the set or streams it from the
  host, and ``--feed_world W`` feeds world 1 the global batches of a
  sharded world of W ranks. Each step's images are checked against the
  dataset rows that the stream names, and a shard against its chunk after
  each rotation (``data`` in the output):

      python -m contrad_tpu_torch.parallel._mh_worker --rank 0 --world 2 \\
          --port 12345 --device cpu --steps 4 --out /tmp/run

* ``--cases FILE``: the steps a test prepared (``torch.save`` of a dict of
  named cases: the G and D modules, the trainer's arguments, and each
  step's global images, labels and draws), run with plain SGD that records
  its gradients; each rank keeps its rows of the global inputs. The tests
  hold these to the JAX package's step on its 8-device mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Any, Callable, ContextManager, Dict, List, Optional

import torch


class RecordingSGD:
    """``p -= lr * g``, keeping every gradient list it was given."""

    def __init__(self, params, lr: float):
        self.params, self.lr = list(params), lr
        self.grads: List[List[torch.Tensor]] = []
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        self.grads.append([g.detach().cpu().clone() for g in grads])
        for p, g in zip(self.params, grads, strict=True):
            p.sub_(self.lr * g)
        self.count += 1

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, state):
        self.count = state["count"]


def record_first_step(opt) -> List[List[torch.Tensor]]:
    """Make ``opt`` (a ``ScheduledAdam``) keep a copy of the gradients of
    its first ``step``; returns the list they go to."""
    seen: List[List[torch.Tensor]] = []
    step = opt.step

    def recording(grads):
        if not seen:
            seen.append([g.detach().cpu().clone() for g in grads])
        return step(grads)

    opt.step = recording
    return seen


def flat_state(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a (nested) state dict, copied to the CPU, by path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().clone()}
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_state(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_state(v, f"{prefix}/{i}"))
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        out[prefix] = torch.tensor(tree)
    return out


class StepMeter:
    """Per step: milliseconds (the card synchronised at both ends), the
    blur's launches and the collectives' calls, bytes and seconds."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows: List[Dict[str, float]] = []

    def __enter__(self):
        from contrad_tpu_torch.ops import blur
        from contrad_tpu_torch.parallel import collectives

        self._sync()
        self._t0 = time.perf_counter()
        self._blur = blur.blur2d.launches
        self._coll = dict(collectives.counts)
        return self

    def __exit__(self, *exc):
        from contrad_tpu_torch.ops import blur
        from contrad_tpu_torch.parallel import collectives

        self._sync()
        row = {"ms": 1e3 * (time.perf_counter() - self._t0),
               "blur_launches": blur.blur2d.launches - self._blur}
        row.update({f"collective_{k}": collectives.counts[k] - v
                    for k, v in self._coll.items()})
        self.rows.append(row)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _trainer(kind: str, G, D, g_tx, d_tx, kwargs: Dict[str, Any]):
    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.training import GANTrainer, StyleGAN2Trainer

    kwargs = dict(kwargs)
    kwargs["augment"] = get_augment(kwargs.pop("aug", "none"))
    real = kwargs.pop("real_aug", None)
    kwargs["real_augment"] = get_augment(real) if real else None
    cls = StyleGAN2Trainer if kind == "sg2" else GANTrainer
    return cls(G, D, g_optimizer=g_tx, d_optimizer=d_tx, **kwargs)


def _to_device(tree, device, dtype=None):
    """``tree``'s tensors on ``device``, floating ones in ``dtype``."""
    if isinstance(tree, torch.Tensor):
        if dtype is not None and tree.is_floating_point():
            tree = tree.to(dtype)
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, dtype) for v in tree)
    return tree


def run_case(case: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """One prepared case (see the module docstring) on this rank's rows."""
    from contrad_tpu_torch.parallel.mesh import local_rows

    G, D = case["G"].to(device), case["D"].to(device)
    dtype = next(D.parameters()).dtype
    g_tx = RecordingSGD(G.parameters(), case["lr"])
    d_tx = RecordingSGD(D.parameters(), case["lr"])
    trainer = _trainer(case["kind"], G, D, g_tx, d_tx, case["trainer"])
    batch = case["batch"]
    meter, metrics = StepMeter(device), []
    for step in case["steps"]:
        images = local_rows(_to_device(step["images"], device, dtype), batch)
        draws = local_rows(_to_device(step["draws"], device, dtype), batch)
        kw: Dict[str, Any] = {"ema_decay": step.get("ema_decay", 0.0),
                              "draws": draws}
        if step.get("labels") is not None:
            kw["labels"] = local_rows(
                _to_device(step["labels"], device), batch)
        if case["kind"] == "sg2":
            kw["do_r1"] = step.get("do_r1", False)
        with meter:
            m = trainer.train_step(images, **kw)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "g_grads": g_tx.grads, "d_grads": d_tx.grads,
            "state": flat_state(trainer.state_dict()), "steps": meter.rows}


class ShardedFeed:
    """World 1's feed of the global batches that a sharded world of
    ``world`` ranks trains on (``ShardedDeviceBatchIterator``, one chunk a
    rank): each step, every rank's rows of each critic sub-batch in rank
    order (the port's grouping), gathered from the whole set on the
    device."""

    supports_indexed = True

    def __init__(self, dataset, batch: int, n_critic: int, seed: int,
                 world: int, device: torch.device):
        from contrad_tpu_torch.data.core import DeviceBatchIterator, ShardPlan

        self.plan = ShardPlan(len(dataset), batch * n_critic, world, seed)
        self.n_critic, self.world = n_critic, world
        self.whole = DeviceBatchIterator(dataset, batch * n_critic,
                                         device=device)
        self.labels = self.whole._labels
        self.epoch, self._pos = 0, None

    def next_indices(self):
        import numpy as np

        plan = self.plan
        if self._pos is None or self._pos + plan.local_batch > plan.shard_len:
            if self._pos is not None:
                self.epoch += 1
            self._orders = [plan.order(self.epoch, r)
                            for r in range(self.world)]
            self._pos = 0
        ranks = [plan.chunks[plan.chunk_of(r, self.epoch)][
            self._orders[r][self._pos:self._pos + plan.local_batch]]
            for r in range(self.world)]
        self._pos += plan.local_batch
        rows = np.concatenate([part for j in range(self.n_critic)
                               for part in (np.split(r, self.n_critic)[j]
                                            for r in ranks)])
        return rows.astype(np.int32), self.labels[rows]

    def materialize(self, idx):
        return self.whole.materialize(idx)


class DataAudit:
    """What the data path fed, checked on the host each step: the images
    against the dataset's rows that the stream names (a sharded stream's
    ``dataset_rows``, an index loader's rows), and a sharded rank's whole
    shard against the chunk it must hold after each epoch's rotation, with
    its storage's address (a rotation is in place)."""

    def __init__(self, loader, dataset):
        self.loader, self.dataset = loader, dataset
        self.record: Dict[str, Any] = {
            "path": getattr(loader, "path", type(loader).__name__),
            "rows": [], "gathered_equal": [], "shards": []}

    def check(self, idx, images) -> None:
        loader, rec = self.loader, self.record
        if idx is None:  # host-fed: the batch is the stream's own gather
            return
        rows = (loader.dataset_rows(idx) if hasattr(loader, "dataset_rows")
                else idx)
        want = torch.from_numpy(self.dataset.images[rows])
        rec["rows"].append(rows.tolist())
        rec["gathered_equal"].append(bool(torch.equal(images.cpu(), want)))
        if hasattr(loader, "plan") and hasattr(loader, "rank") and (
                not rec["shards"] or rec["shards"][-1]["epoch"]
                != loader.epoch):
            chunk = loader.plan.chunk_of(loader.rank, loader.epoch)
            rec["shards"].append(dict(
                step=len(rec["rows"]), epoch=loader.epoch, chunk=chunk,
                equal=bool(torch.equal(loader.images.cpu(), torch.from_numpy(
                    self.dataset.images[loader.plan.chunks[chunk]]))),
                storage=loader.images.data_ptr()))


StepContext = Optional[Callable[[int], ContextManager]]


def run_recipe(args, device: torch.device,
               step_context: StepContext = None) -> Dict[str, Any]:
    """The recipe the flags name, drawn by the port (see the module
    docstring); ``step_context(step)``, where given, is entered around each
    step (``chip_smoke.py`` carries leaky-ReLU branches with it)."""
    from contrad_tpu_torch.data.core import (
        DeviceBatchIterator, make_train_loader)
    from contrad_tpu_torch.data.synthetic import synthetic_dataset
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import ScheduledAdam

    img = (args.size, args.size, 3)
    n_classes = 10 if args.conditional else 1
    dataset = synthetic_dataset(img, n=args.data_rows, seed=0,
                                class_signal=args.conditional)
    if args.arch is None and args.trainer == "gan":
        from contrad_tpu_torch.models.sndcgan import DSndcgan, GSndcgan

        torch.manual_seed(args.seed)
        G = GSndcgan(img, ngf=8, nz=16).to(device)
        D = DSndcgan(img, ndf=8, d_hidden=32, n_classes=n_classes).to(device)
    else:
        G, D = get_architecture(args.arch or "stylegan2_tiny", img,
                                device=device, seed=args.seed,
                                n_classes=n_classes)
    if args.dtype == "f64":
        G, D = G.double(), D.double()
    sg2 = args.trainer == "sg2"
    lr, beta = (2e-3, (0.0, 0.99)) if sg2 else (2e-4, (0.5, 0.999))
    g_tx, d_tx = (ScheduledAdam(m.parameters(), lr, beta, warmup=3000,
                                use_warmup=True) for m in (G, D))
    g_seen, d_seen = record_first_step(g_tx), record_first_step(d_tx)
    kwargs = dict(mode="contrad", aug=args.aug, loss_type="nonsat",
                  n_critic=args.n_critic, seed=args.seed)
    if sg2:
        kwargs.update(lbd_r1=args.lbd_r1, d_reg_every=args.d_reg_every)
    trainer = _trainer(args.trainer, G, D, g_tx, d_tx, kwargs)
    if args.feed_world > 1:
        loader = ShardedFeed(dataset, args.batch, args.n_critic, seed=5,
                             world=args.feed_world, device=device)
    else:
        limit = DeviceBatchIterator.MAX_BYTES
        DeviceBatchIterator.MAX_BYTES = args.max_bytes or limit
        try:
            loader = make_train_loader(dataset, args.batch, args.n_critic,
                                       seed=5, device=device,
                                       with_labels=args.conditional)
        finally:
            DeviceBatchIterator.MAX_BYTES = limit
    meter, metrics, data = StepMeter(device), [], DataAudit(loader, dataset)
    for step in range(1, args.steps + 1):
        if loader.supports_indexed:
            idx, labels = loader.next_indices()
            images = loader.materialize(idx)
        else:
            images, labels = next(loader)
            idx = None
        data.check(idx, images)
        kw: Dict[str, Any] = {}
        if sg2:
            kw.update(do_r1=step % args.d_reg_every == 0,
                      ema_decay=0.99 if step > args.ema_start_step else 0.0)
        if args.conditional:
            kw["labels"] = torch.as_tensor(labels, device=device)
        around = step_context(step) if step_context else contextlib.nullcontext()
        with around, meter:
            m = trainer.train_step(images, **kw)
        metrics.append({k: float(v) for k, v in m.items()})
        print(f"step {step}: {meter.rows[-1]['ms']:.1f} ms", flush=True)
    if hasattr(loader, "close"):
        loader.close()
    return {"metrics": metrics, "g_grads": g_seen, "d_grads": d_seen,
            "state": flat_state(trainer.state_dict()), "steps": meter.rows,
            "data": data.record}


def probe_collectives(device: torch.device) -> Dict[str, str]:
    """Which collectives the world's backend takes on tensors of
    ``device``: "ok", or the first line of its error (gloo refuses some
    on CUDA tensors)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.ones(4, device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, device=device), x),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 (the refusal is the finding)
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--port", type=int, default=0,
                   help="the rendezvous port; 0: the CONTRAD_* variables "
                        "of the environment name the world")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--cases", default=None,
                   help="a file of prepared cases (see the docstring)")
    p.add_argument("--out", required=True,
                   help="each rank writes <out>.rank<r>.pt")
    p.add_argument("--trainer", choices=["gan", "sg2"], default="gan")
    p.add_argument("--conditional", action="store_true")
    p.add_argument("--n_critic", type=int, default=1)
    p.add_argument("--arch", default=None,
                   help="an architecture of the registry; default: the JAX "
                        "worker's SNDCGAN widths, or stylegan2_tiny for sg2")
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--batch", type=int, default=8, help="the global batch")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--aug", default="simclr")
    p.add_argument("--lbd_r1", type=float, default=0.1)
    p.add_argument("--d_reg_every", type=int, default=2,
                   help="sg2: the lazy R1 runs where step %% this == 0")
    p.add_argument("--ema_start_step", type=int, default=2,
                   help="sg2: the EMA decay is 0.99 after this step, else 0")
    p.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    p.add_argument("--data_rows", type=int, default=64)
    p.add_argument("--max_bytes", type=int, default=0,
                   help="DeviceBatchIterator.MAX_BYTES for the choice of "
                        "make_train_loader (0: the default): below the "
                        "set's bytes a world shards it, or streams it from "
                        "the host")
    p.add_argument("--feed_world", type=int, default=0,
                   help="world 1 only: train on the global batches of a "
                        "sharded world of this many ranks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--time_collectives", action="store_true",
                   help="synchronise around each collective to time it")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN deterministic, TF32 off")
    return p.parse_args(argv)


def main(argv=None, step_context: StepContext = None) -> int:
    """Join the world (or not), run, write ``<out>.rank<r>.pt``;
    ``step_context`` as :func:`run_recipe` takes it."""
    args = parse_args(argv)
    from contrad_tpu_torch import resolve_device
    from contrad_tpu_torch.hostenv import rank_env
    from contrad_tpu_torch.parallel import collectives, data_shard, mesh

    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.world > 1:
        if args.port:  # else the spawner's CONTRAD_* variables name it
            os.environ.update(rank_env({}, args.port, args.rank, args.world))
        device = mesh.init_distributed(args.device)
        if data_shard() != (args.rank, args.world):
            raise RuntimeError(f"joined as {data_shard()}, not "
                               f"{(args.rank, args.world)}")
    else:
        device = resolve_device(args.device)
    print(f"mh_worker rank {args.rank}/{args.world}: on {device}",
          flush=True)
    collectives.TIMED = args.time_collectives
    probe = (probe_collectives(device) if args.world > 1
             and mesh.backend() == "gloo" and device.type == "cuda" else None)
    if args.cases:
        cases = torch.load(args.cases, weights_only=False)
        result = {name: run_case(case, device) for name, case in cases.items()}
    else:
        result = dict(run_recipe(args, device, step_context),
                      gloo_cuda=probe)
    torch.save(result, f"{args.out}.rank{args.rank}.pt")
    mesh.shutdown()
    print(f"mh_worker rank {args.rank}/{args.world}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
