"""Kernels launched on the device a step in the traced window."""


def read(run):
    n = len(run["trace"].kernels())
    return n / run["steps"] if n else None
