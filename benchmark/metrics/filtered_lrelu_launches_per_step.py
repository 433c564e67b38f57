"""Launches of the hand-written filtered leaky ReLU kernel (StyleGAN3) a
step over the traced window: the program counter
``filtered_lrelu.launches``, each forward and each backward, which the
graph runner advances at each replay by the launches its graph holds. None
where the program has no such counter or launched nothing."""


def read(run):
    n = run["counters"].get("filtered_lrelu.launches")
    return n / run["steps"] if n else None
