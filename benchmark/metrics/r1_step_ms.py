"""Device milliseconds of a step with the lazy R1 penalty: the mean kernel
time between the ``step`` begin marks of the window's R1 steps, which need
no other mark in place (``harness/phases.py``)."""

from benchmark.harness.phases import step_ms, steps_of


def read(run):
    steps = steps_of(run)
    return None if steps is None else step_ms(steps, r1=True)
