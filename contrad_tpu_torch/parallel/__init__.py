"""Data parallelism over processes, one per card (the counterpart of
``contrad_tpu/parallel``): the world (``mesh.py``) and the collectives the
train step calls (``collectives.py``)."""

from contrad_tpu_torch.parallel.collectives import (
    all_reduce_grads, all_reduce_sum, gather_rows, global_var_mean,
    ring_shift_)
from contrad_tpu_torch.parallel.mesh import (
    barrier, broadcast_floats, broadcast_object, data_shard, host_batched,
    in_world, init_distributed, place_global_batch, round_up_batch, shutdown,
    world_all)

__all__ = ["all_reduce_grads", "all_reduce_sum", "barrier",
           "broadcast_floats", "broadcast_object", "data_shard",
           "gather_rows", "global_var_mean", "host_batched", "in_world",
           "init_distributed", "place_global_batch", "ring_shift_",
           "round_up_batch", "shutdown", "world_all"]
