"""Launches of the hand-written blur kernel a step over the traced window
(the program counter ``blur2d.launches``, which the graph runner advances
at each replay by the launches its graph holds)."""


def read(run):
    n = run["counters"].get("blur2d.launches")
    return n / run["steps"] if n else None
