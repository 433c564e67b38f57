"""Device milliseconds of a step with the lazy R1 penalty: the mean kernel
time between the ``step`` begin marks of the window's R1 steps
(``harness/phases.py``)."""

from benchmark.harness.phases import of


def read(run):
    p = of(run)
    return None if p is None else p.step_ms(r1=True)
