"""Device milliseconds a step of the optimiser updates: both Adam updates
with D's spectral-norm ``u`` commits, and the EMA of G (the ``update``
phase's self time, ``harness/phases.py``)."""

from benchmark.harness.phases import ms_per_step


def read(run):
    return ms_per_step(run, "update")
