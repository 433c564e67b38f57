"""The train step's phases in a traced window, from the marks the program
puts on the device: empty kernels named ``contrad_mark_<phase>_begin`` and
``contrad_mark_<phase>_end`` (the port's ``utils/trace.py``), which the
step's CUDA graphs hold between the phases' kernels.

The kernels are walked in start order with a stack of the open phases: each
kernel's time goes to the innermost open phase (its self time), or to
``unmarked`` outside every phase; the marks' own time is counted apart. So
the self times, ``unmarked`` and the marks add up to the window's kernel
time. Steps are cut at the ``step`` begin marks: a step's kernels run from
its begin mark to the next one (the last step's to the window's end), and a
step holding an ``r1`` mark is an R1 step. The augment's backward and the
double backward of R1 run in the enclosing backward, so they fall to ``g``
and ``d``.

A program with no marks (an older one), marks that do not pair up, or steps
that are not the window's (their count, or that of R1 steps, differs from
the run's) read as None: the phase metrics are then missing, not wrong."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

MARK = re.compile(r"^contrad_mark_(\w+)_(begin|end)$")


@dataclasses.dataclass
class Phases:
    """Seconds of kernel time in the window."""

    self_s: Dict[str, float]  # phase -> self time
    unmarked_s: float  # kernels outside every phase
    marks_s: float  # the marks' own time
    marks: int
    steps: List[Dict]  # per step: {"kernel_s", "r1"}

    def total_s(self) -> float:
        return sum(self.self_s.values()) + self.unmarked_s + self.marks_s

    def step_ms(self, r1: bool) -> Optional[float]:
        """Mean kernel milliseconds of the steps with (or without) R1."""
        times = [s["kernel_s"] for s in self.steps if s["r1"] == r1]
        return 1e3 * sum(times) / len(times) if times else None


def read(kernels) -> Optional[Phases]:
    """The phases of ``kernels`` (``(name, start, end)``, any order); None
    where there are no marks or they do not pair up."""
    stack: List[str] = []
    self_s: Dict[str, float] = {}
    unmarked = marks_s = 0.0
    marks = 0
    steps: List[Dict] = []
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        m = MARK.match(name)
        if m is None:
            if stack:
                self_s[stack[-1]] = self_s.get(stack[-1], 0.0) + (e - s)
            else:
                unmarked += e - s
            if steps:
                steps[-1]["kernel_s"] += e - s
            continue
        marks += 1
        marks_s += e - s
        if steps:
            steps[-1]["kernel_s"] += e - s
        phase, edge = m.groups()
        if edge == "begin":
            if phase == "step":
                if stack:  # a step inside another phase
                    return None
                steps.append({"kernel_s": e - s, "r1": False})
            elif phase == "r1" and steps:
                steps[-1]["r1"] = True
            stack.append(phase)
        elif not stack or stack.pop() != phase:
            return None
    if stack or not marks:
        return None
    return Phases(self_s, unmarked, marks_s, marks, steps)


def of(run) -> Optional[Phases]:
    """The phases of a traced run's window, where its steps are the run's
    (``run["steps"]`` steps, ``run["kinds"]["r1"]`` of them R1 steps)."""
    p = read(run["trace"].kernels())
    if p is None or len(p.steps) != run["steps"]:
        return None
    if sum(s["r1"] for s in p.steps) != run["kinds"].get("r1", 0):
        return None
    return p


def ms_per_step(run, *names: str) -> Optional[float]:
    """The self time of phases ``names`` a step, in milliseconds."""
    p = of(run)
    if p is None:
        return None
    return 1e3 * sum(p.self_s.get(n, 0.0) for n in names) / run["steps"]
