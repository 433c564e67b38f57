"""Device milliseconds a step of the kernels of the convolution class
(cuDNN's forward, data- and weight-gradient kernels), by the benchmark's
name-to-class table (``harness/trace.py``)."""


def read(run):
    s = run["trace"].class_seconds("convolution")
    return 1e3 * s / run["steps"] if s else None
