"""A world of train processes, one per card (the counterpart of
``contrad_tpu/parallel/mesh.py``).

The JAX package trains data-parallel over a device mesh: one jitted step over
the global batch, XLA inserting every collective. The port runs one process
per card, as the reference did (an NCCL process group, one process a GPU);
``parallel/collectives.py`` holds the collectives the step calls itself.
Outside a world (no ``init_distributed``) every helper here is the identity
of a world of one, and no collective is called.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from contrad_tpu_torch import resolve_device

# How long a rank waits for the others at the rendezvous and in a collective.
TIMEOUT = datetime.timedelta(seconds=600)


def in_world() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def data_shard() -> Tuple[int, int]:
    """(rank, world) for data sharding: the counterpart of the reference's
    ``DistributedSampler(rank, world_size)`` (``train_gan.py:245-251``).
    (0, 1) outside a world."""
    if not in_world():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def backend() -> Optional[str]:
    """The world's backend (``nccl`` or ``gloo``), None outside a world."""
    return dist.get_backend() if in_world() else None


def _rendezvous() -> Tuple[str, int, int, int]:
    """(address, world, rank, local rank) from the environment: the port's
    ``CONTRAD_COORDINATOR=host:port``, ``CONTRAD_NUM_PROCESSES``,
    ``CONTRAD_PROCESS_ID`` (and ``CONTRAD_LOCAL_RANK``), else torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``."""
    env = os.environ
    if env.get("CONTRAD_COORDINATOR"):
        world = int(env["CONTRAD_NUM_PROCESSES"])
        rank = int(env["CONTRAD_PROCESS_ID"])
        local = env.get("CONTRAD_LOCAL_RANK")
        return (env["CONTRAD_COORDINATOR"], world, rank,
                -1 if local is None else int(local))
    if "RANK" in env and "WORLD_SIZE" in env:
        addr = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env['MASTER_PORT']}"
        return (addr, int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", -1)))
    raise RuntimeError(
        "--multihost needs a rendezvous: launch with torchrun, or set "
        "CONTRAD_COORDINATOR=host:port, CONTRAD_NUM_PROCESSES and "
        "CONTRAD_PROCESS_ID (hostenv.spawn_world)")


def init_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Join the world the environment names (:func:`_rendezvous`) and
    return the device this process trains on. The counterpart of
    ``jax.distributed.initialize`` (``mesh.py:init_distributed``) and of the
    reference's ``dist.init_process_group('nccl', 'tcp://...', rank,
    world_size)`` (``train_gan.py:239-242``).

    The backend is ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``; gloo on
    ``cuda`` only when asked for (``CONTRAD_BACKEND=gloo``, which
    ``hostenv.rank_env`` sets), as when two processes share one card, which
    NCCL refuses. Each process takes ``cuda:<local rank>``, the local rank
    being ``CONTRAD_LOCAL_RANK`` or ``LOCAL_RANK`` where set, else the rank
    modulo the visible cards. One collective runs before this returns, so
    the communicator exists before any step (or CUDA graph capture) calls
    one."""
    device = resolve_device(device)
    addr, world, rank, local = _rendezvous()
    backend = os.environ.get("CONTRAD_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: use nccl or gloo")
    if device.type == "cuda":
        if local < 0:
            local = rank % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs cuda; use gloo on the CPU")
    dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    probe = torch.ones(1, device=device if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"the world's first all-reduce gave {probe.item()}"
                           f", not {world}")
    return device


def shutdown() -> None:
    """Leave the world (after a last barrier); nothing outside one."""
    if in_world():
        barrier()
        dist.destroy_process_group()


def _host_device() -> torch.device:
    """Where the host-side helpers put their small tensors: the card under
    NCCL (it takes no CPU tensor), the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Wait for every rank (nothing outside a world); under NCCL on this
    process's card."""
    if not in_world():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def round_up_batch(batch_size: int, world: Optional[int] = None) -> int:
    """Smallest multiple of the world's size >= ``batch_size`` (every rank
    takes the same number of rows); prints when it changes."""
    world = data_shard()[1] if world is None else world
    rounded = batch_size + (-batch_size) % world
    if rounded != batch_size:
        print(f"batch_size rounded up to {rounded} "
              f"(device-count {world} multiple)")
    return rounded


def world_all(flag: bool) -> bool:
    """True iff ``flag`` is true on EVERY process. Collective: all
    processes must call it. It decides whether an optional collective (the
    in-loop FID) runs, so that no rank enters a collective the others never
    join."""
    if not in_world():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_host_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def broadcast_floats(*vals: float) -> tuple:
    """Rank 0's values on every process (the identity outside a world).
    Collective. For decisions made from host float math (scipy's sqrtm,
    np.cov) that gate collectives or writes: two BLAS builds can differ in
    the last ulps, and a diverged ``is_best`` would desynchronise the
    ranks."""
    if not in_world():
        return vals
    t = torch.tensor(vals, dtype=torch.float64, device=_host_device())
    dist.broadcast(t, src=0)
    return tuple(float(v) for v in t.cpu())


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every process (``obj`` outside a
    world)."""
    if not in_world():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_host_device())
    return box[0]


def local_rows(tree, batch: int, shard: Optional[Tuple[int, int]] = None):
    """This rank's rows of each per-sample leaf of ``tree`` (nested dicts,
    lists and tuples of tensors or arrays; None and other leaves pass
    through) made for a global batch of ``batch``: a leaf of ``parts *
    batch`` rows holds ``parts`` consecutive parts of the global batch
    (the two views and the fakes of a ContraD D pass, the critic
    sub-batches), and each part is sliced to the rank's contiguous share.
    A 0-d leaf (a per-batch draw) stays whole. ``shard`` is (rank, world),
    this process's by default; the tree itself in a world of one."""
    rank, world = data_shard() if shard is None else shard
    if world == 1:
        return tree
    if batch % world:
        raise ValueError(f"global batch {batch} must divide device count "
                         f"{world}")
    per = batch // world

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(one(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
            return x
        parts = x.shape[0] // batch
        if parts * batch != x.shape[0]:
            raise ValueError(f"a draw of {x.shape[0]} rows is no whole "
                             f"number of global batches of {batch}")
        rest = tuple(x.shape[1:])
        return x.reshape((parts, batch) + rest)[
            :, rank * per:(rank + 1) * per].reshape((parts * per,) + rest)

    return one(tree)


def place_global_batch(local, device: str | torch.device) -> torch.Tensor:
    """This process's rows of the global batch, on its device: each rank
    feeds its own rows and the step's collectives join them (the counterpart
    of ``jax.make_array_from_process_local_data``)."""
    return torch.as_tensor(np.asarray(local)).to(device)


def host_batched(forward: Callable[[torch.Tensor], torch.Tensor],
                 device: str | torch.device,
                 chunk: Optional[int] = None) -> Callable[[np.ndarray],
                                                          np.ndarray]:
    """Wrap a device ``forward`` (images -> features) into a host function
    that takes any number of NHWC images and returns every row's features
    on every rank. In a world each rank runs its share of the rows (the
    batch padded with its last image to a multiple of the world) and the
    features are gathered in rank order; ``chunk`` bounds the rows one
    forward call takes on a rank. uint8 inputs are scaled to [0, 1]
    floats."""
    from contrad_tpu_torch.parallel.collectives import gather_rows

    def call(images) -> np.ndarray:
        x = np.asarray(images)
        n = len(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        rank, world = data_shard()
        pad = (-n) % world
        if pad:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        per = len(x) // world
        mine = x[rank * per:(rank + 1) * per]
        step = chunk or max(per, 1)
        with torch.no_grad():
            outs = [forward(place_global_batch(mine[i:i + step], device))
                    for i in range(0, per, step)]
            feats = gather_rows(torch.cat(outs))
        return feats.double().cpu().numpy()[:n]

    return call
