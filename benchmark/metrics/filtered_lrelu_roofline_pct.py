"""The filtered leaky ReLU kernel's share of its roofline over the traced
window: the roofline time of every launch of the window's steps (the
larger of its bytes at 3.35 TB/s and its multiply-adds at the FP32 peak,
from the model family's table, ``counts/filtered_lrelu.py``) over the
device time of the kernels named ``filtered_lrelu_*`` in the trace. None
where the trace holds none."""

import re

from benchmark.counts.filtered_lrelu import step_seconds

KERNELS = re.compile(r"\bfiltered_lrelu_\w*kernel")


def read(run):
    seconds = sum(e - s for name, s, e in run["trace"].kernels()
                  if KERNELS.search(name))
    if not seconds:
        return None
    ref = run["config"]["reference"]
    item = 2 if run["dtype"] == "bf16" else 4
    batch = ref["recipe"]["batch_size"]
    bound = sum(n * step_seconds(ref["model"], batch, kind, item)
                for kind, n in run["kinds"].items())
    return 100.0 * bound / seconds
