"""Device milliseconds a step of the D updates' own kernels: the fakes' G
forward where a D update draws them, the mode's D loss and penalty, R1's
forward and input gradient, and their backward with the augment's and R1's
double backward (the ``d`` and ``r1`` phases' self time,
``harness/phases.py``)."""

from benchmark.harness.phases import ms_per_step


def read(run):
    return ms_per_step(run, "d", "r1")
