"""Device milliseconds a step of the kernels of the elementwise class
(PyTorch's vectorised and unrolled elementwise kernels, ``where``,
indexing), by the benchmark's name-to-class table (``harness/trace.py``)."""


def read(run):
    s = run["trace"].class_seconds("elementwise")
    return 1e3 * s / run["steps"] if s else None
