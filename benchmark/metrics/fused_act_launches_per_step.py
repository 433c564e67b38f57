"""Launches of the hand-written fused bias + leaky ReLU + gain kernel a
step over the traced window (the program counter
``fused_leaky_relu.launches``, its forward, gradient and bias-sum launches,
which the graph runner advances at each replay by the launches its graph
holds)."""


def read(run):
    n = run["counters"].get("fused_leaky_relu.launches")
    return n / run["steps"] if n else None
