"""Device milliseconds a step of the G update's own kernels: G's forward,
the G loss through D and their backward, the augment's backward included
(the ``g`` phase's self time, ``harness/phases.py``)."""

from benchmark.harness.phases import ms_per_step


def read(run):
    return ms_per_step(run, "g")
