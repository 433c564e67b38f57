"""Seconds the graph runner spent warming up and capturing the step's CUDA
graphs in set-up (``BlockRunner.stats["capture_seconds"]``, summed over
the step kinds)."""


def read(run):
    return run["capture_s"] or None
