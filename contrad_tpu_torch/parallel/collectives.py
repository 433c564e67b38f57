"""The collectives of a data-parallel train step: what XLA inserts in the
JAX package's step, written out (the JAX losses are functions of the global
batch, ``contrad_tpu/training/losses.py:4-10``).

**One gradient convention.** Every rank computes the whole global loss, the
same number on every rank, from the parts it gathers (:func:`gather_rows`),
each rank's own rows computed by that rank. Backward, :func:`gather_rows`
keeps this rank's slice of the gathered gradient (the reference's
``GatherLayer``); a statistic taken over the world (:func:`global_var_mean`)
sums its gradient over the world. So each rank's parameter gradient is the
part of the global gradient that flows through its own rows, and
:func:`all_reduce_grads` sums them (SUM, not a mean) into the global
gradient, equal on every rank, before the optimisers step. The optimisers
then move every replica the same way.

Outside a world every function here is the identity and calls nothing: the
world-less step is the one it was. In a world of one the collectives run
(copies), so that a world of one on the card shows the collectives inside the
CUDA graphs.

The calls and bytes of every collective are counted in :data:`counts`
(host-side, at the call: a CUDA graph's runner adds its replays back); with
:data:`TIMED` each call is also timed, the card synchronised around it
(eager steps only: a graph capture cannot synchronise).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from contrad_tpu_torch.parallel.mesh import backend, data_shard, in_world

# collectives issued by this module: calls, payload bytes and (TIMED) seconds
counts: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}
TIMED = False

BUCKET_ELEMENTS = 1 << 25  # the flat gradient buckets' size (128 MB float32)


def _issue(t: torch.Tensor, call: Callable[[], None]) -> None:
    """Run the collective ``call`` of payload ``t``, counted (and timed)."""
    counts["calls"] += 1
    counts["bytes"] += t.numel() * t.element_size()
    if not TIMED:
        call()
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    call()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    counts["seconds"] += time.perf_counter() - t0


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    _issue(t, lambda: dist.all_reduce(t))
    return t


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """(world * n, ...) rows, rank-major, of every rank's (n, ...) ``x``:
    into one tensor under NCCL (the form captured in the CUDA graphs), as a
    list under gloo, which takes it on CPU and CUDA tensors alike (checked
    on the card, ``chip_smoke.py`` phase 12b)."""
    world = data_shard()[1]
    x = x.contiguous()
    if backend() == "nccl":
        out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _issue(x, lambda: dist.all_gather_into_tensor(out, x))
        return out
    parts = [torch.empty_like(x) for _ in range(world)]
    _issue(x, lambda: dist.all_gather(parts, x))
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        rank = data_shard()[0]
        return grad[rank * ctx.rows:(rank + 1) * ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone())


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` stacked along dim 0 in rank order, the
    global batch's part that ``x`` is this rank's share of; differentiable:
    backward keeps this rank's slice (see the module docstring). ``x``
    itself outside a world."""
    if not in_world():
        return x
    return _GatherRows.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the world, differentiable: backward sums the
    gradient over the world. ``x`` itself outside a world."""
    if not in_world():
        return x
    return _AllReduceSum.apply(x)


def global_var_mean(x: torch.Tensor, dims: Sequence[int]):
    """(biased variance, mean) over ``dims`` of the global batch whose
    rows, an equal number on each rank, are ``x`` on this rank; with the
    gradients of the global statistics. ``torch.var_mean(x, dims,
    correction=0)`` outside a world."""
    if not in_world():
        return torch.var_mean(x, dim=list(dims), correction=0)
    world = data_shard()[1]
    mean = all_reduce_sum(x.mean(dim=list(dims))) / world
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    sq = (x - mean.reshape(shape)).square().mean(dim=list(dims))
    return all_reduce_sum(sq) / world, mean


def ring_shift_(t: torch.Tensor) -> torch.Tensor:
    """Shift ``t`` one rank round the ring, in place: each rank sends its
    ``t`` to rank + 1 and takes rank - 1's (JAX's ``lax.ppermute`` over the
    ring, ``contrad_tpu/data/core.py:217-223``). The result is copied back
    into ``t``'s own storage, so that a CUDA graph that reads ``t`` reads
    the shifted rows. NCCL moves it card to card; gloo's point-to-point
    calls take host memory, so under gloo a CUDA tensor goes through a host
    copy. Not differentiable. ``t`` itself, untouched, in a world of one or
    outside a world."""
    rank, world = data_shard()
    if world == 1:
        return t
    send = t.contiguous()
    if backend() == "gloo" and t.is_cuda:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
           dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
    _issue(send, lambda: [w.wait() for w in dist.batch_isend_irecv(ops)])
    t.copy_(recv)
    return t


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The world's sum of each gradient (``grads`` as ``training/step.py::
    _grads`` returns them, before the optimiser's ``step``), reduced in
    flat buckets of one dtype (the parameters': float32 masters, also under
    ``--opt_grads bf16``, whose cast comes after, as in the JAX step). The
    list itself outside a world."""
    grads = list(grads)
    if not in_world():
        return grads
    out: List[torch.Tensor] = [None] * len(grads)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for members in by_dtype.values():
        bucket: List[int] = []
        size = 0
        for i in members + [None]:
            if i is not None and (size + grads[i].numel() <= BUCKET_ELEMENTS
                                  or not bucket):
                bucket.append(i)
                size += grads[i].numel()
                continue
            flat = _all_reduce_(torch.cat([grads[j].reshape(-1)
                                           for j in bucket]))
            for j, part in zip(bucket, flat.split(
                    [grads[j].numel() for j in bucket])):
                out[j] = part.view_as(grads[j])
            if i is not None:
                bucket, size = [i], grads[i].numel()
    return out
