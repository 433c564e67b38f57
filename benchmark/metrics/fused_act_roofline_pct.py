"""The fused bias + leaky ReLU + gain kernel's share of its byte bound over
the traced window: the bytes every launch of the window's steps must move
(inputs and outputs once each, from the model family's table of the step's
activations, ``counts/fused_act.py``) at 3.35 TB/s, over the device time of
its kernels in the trace (``bias_act_*elementwise_kernel`` and
``bias_grad_sum_kernel``, chosen by name here)."""

import re

from benchmark.counts.flops import HBM_BYTES_PER_S
from benchmark.counts.fused_act import step_bytes

KERNELS = re.compile(r"bias_act_\w*elementwise_kernel|bias_grad_sum_kernel")


def read(run):
    seconds = sum(e - s for name, s, e in run["trace"].kernels()
                  if KERNELS.search(name))
    if not seconds:
        return None
    ref = run["config"]["reference"]
    item = 2 if run["dtype"] == "bf16" else 4
    batch = ref["recipe"]["batch_size"]
    total = sum(n * step_bytes(ref["model"], batch, kind, item)
                for kind, n in run["kinds"].items())
    return 100.0 * total / HBM_BYTES_PER_S / seconds
