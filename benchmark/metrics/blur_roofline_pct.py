"""The blur kernel's share of its byte bound over the traced window: the
bytes every launch of the window's steps must move (input and output once
each, from the benchmark's table of the step's blur shapes,
``counts/blur.py``) at 3.35 TB/s, over the device time of the blur's
kernels in the trace."""

from benchmark.counts.blur import step_bytes
from benchmark.counts.flops import HBM_BYTES_PER_S


def read(run):
    seconds = run["trace"].class_seconds("blur")
    if not seconds:
        return None
    ref = run["config"]["reference"]
    item = 2 if run["dtype"] == "bf16" else 4
    batch = ref["recipe"]["batch_size"]
    total = sum(n * step_bytes(ref["model"], batch, kind, item)
                for kind, n in run["kinds"].items())
    return 100.0 * total / HBM_BYTES_PER_S / seconds
