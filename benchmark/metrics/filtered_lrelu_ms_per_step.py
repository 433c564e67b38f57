"""Device milliseconds a step of the filtered leaky ReLU kernel's launches
(StyleGAN3), forward and backward, over the traced window: the kernels
named ``filtered_lrelu_*`` in the trace, which the benchmark's name ->
class table leaves in ``other``. None where the trace holds none."""

import re

KERNELS = re.compile(r"\bfiltered_lrelu_\w*kernel")


def read(run):
    seconds = sum(e - s for name, s, e in run["trace"].kernels()
                  if KERNELS.search(name))
    return 1e3 * seconds / run["steps"] if seconds else None
