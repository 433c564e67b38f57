"""Device milliseconds a step of the augments' forward applications (the
real augment, the mode's views of reals and fakes, R1's): the ``aug``
phase's self time (``harness/phases.py``). Their backward runs in the G and
D updates' backward and is counted there."""

from benchmark.harness.phases import ms_per_step


def read(run):
    return ms_per_step(run, "aug")
