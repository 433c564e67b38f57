"""``harness/phases.py`` and the phase metrics on hand-made traces: nesting
(a kernel to the innermost open phase), steps cut at the ``step`` begin
marks, R1 steps found, marks that do not pair up or steps that are not the
run's read as None, and the self times, the unmarked kernels and the marks
adding up to the window's kernel time."""

from __future__ import annotations

import pytest

from conftest import ROOT


def _marks(*spec):
    """Kernels from a spec of mark edges (``"+g"`` begins g, ``"-g"`` ends
    it) and kernels (``("name", seconds)``), one after another from 0, a
    mark 1e-6 s long."""
    out, t = [], 0.0
    for item in spec:
        if isinstance(item, str):
            edge = "begin" if item[0] == "+" else "end"
            name, dur = f"contrad_mark_{item[1:]}_{edge}", 1e-6
        else:
            name, dur = item
        out.append((name, t, t + dur))
        t += dur + 1e-7
    return out


def _step(r1: bool):
    d = (["+d", "+aug", ("aug_k", 0.5), "-aug"]
         + (["+r1", "+aug", ("aug_k", 0.25), "-aug", ("r1_k", 2.0), "-r1"]
            if r1 else [])
         + [("d_bwd", 3.0), "-d", "+update", ("adam", 0.125), "-update"])
    return (["+step", ("draw", 0.0625), "+update", ("ema", 0.03125),
             "-update", "+g", ("g_fwd", 1.0), "+aug", ("aug_k", 0.5), "-aug",
             ("g_bwd", 1.5), "-g", "+update", ("adam", 0.125), "-update"]
            + d + ["-step"])


def _trace(kernels):
    from benchmark.harness.trace import Trace

    return Trace(kernels[-1][2] + 1.0, kernels, [])


def test_self_times_nest_and_add_up_to_the_kernel_time():
    from benchmark.harness import phases

    kernels = _marks(("before", 0.25), *_step(False), *_step(True),
                     ("after", 0.5))
    p = phases.read(kernels)
    assert p.self_s == pytest.approx({
        "step": 2 * 0.0625, "update": 2 * (0.03125 + 2 * 0.125),
        "g": 2 * 2.5, "aug": 2 * 1.0 + 0.25, "d": 2 * 3.0, "r1": 2.0})
    assert p.unmarked_s == pytest.approx(0.75)
    n_marks = sum(1 for k in kernels if k[0].startswith("contrad_mark_"))
    assert p.marks == n_marks == 16 + 20
    assert p.marks_s == pytest.approx(n_marks * 1e-6)
    assert p.total_s() == pytest.approx(sum(e - s for _, s, e in kernels),
                                        rel=1e-12)
    # steps from one step begin mark to the next, the last to the end
    assert [s["r1"] for s in p.steps] == [False, True]
    assert p.step_ms(False) == pytest.approx(1e3 * (6.84375 + 16e-6))
    assert p.step_ms(True) == pytest.approx(1e3 * (9.09375 + 20e-6 + 0.5))
    assert sum(s["kernel_s"] for s in p.steps) + 0.25 == pytest.approx(
        sum(e - s for _, s, e in kernels))


@pytest.mark.parametrize("spec", [
    ["+step", ("k", 1.0), "+g", ("k", 1.0), "-step", "-g"],  # crossed
    ["+step", "+g", ("k", 1.0), "-step"],  # g never ends
    ["+step", ("k", 1.0), "-step", "-g"],  # an end with no begin
    ["+g", "+step", ("k", 1.0), "-step", "-g"],  # a step inside a phase
    [("k", 1.0), ("k", 2.0)],  # no marks: an older program
])
def test_marks_that_do_not_pair_up_read_as_none(spec):
    from benchmark.harness import phases

    assert phases.read(_marks(*spec)) is None


def _run(kernels, steps, kinds):
    return {"trace": _trace(kernels), "steps": steps, "kinds": kinds,
            "window_s": kernels[-1][2] + 1.0}


def test_the_readers_per_step_and_the_r1_step():
    from benchmark.harness.spec import load_reader

    kernels = _marks(*_step(False), *_step(True), *_step(False),
                     *_step(True))
    run = _run(kernels, 4, {"plain": 2, "r1": 2})
    read = {n: load_reader(n, ROOT) for n in (
        "g_phase_ms_per_step", "d_phase_ms_per_step", "aug_ms_per_step",
        "update_ms_per_step", "r1_step_ms")}
    assert read["g_phase_ms_per_step"](run) == pytest.approx(2500.0)
    assert read["d_phase_ms_per_step"](run) == pytest.approx(4000.0)
    assert read["aug_ms_per_step"](run) == pytest.approx(1125.0)
    assert read["update_ms_per_step"](run) == pytest.approx(281.25)
    assert read["r1_step_ms"](run) == pytest.approx(1e3 * (9.09375 + 20e-6))
    # steps or R1 steps that are not the run's: missing, not wrong
    for bad in (_run(kernels, 5, {"plain": 3, "r1": 2}),
                _run(kernels, 4, {"plain": 3, "r1": 1}),
                _run(_marks(("k", 1.0)), 4, {"plain": 2, "r1": 2})):
        assert all(r(bad) is None for r in read.values())



def test_a_mark_out_of_place_inside_a_step_leaves_the_steps():
    """An ``aug`` end mark that starts before its begin mark (as one did in
    a bf16 replay): the phases' self times read None, the steps, cut at
    their begin marks alone, still give the R1 step's time."""
    from benchmark.harness.spec import load_reader

    r1 = _step(True)
    at = r1.index("+g") + 2
    assert r1[at:at + 3] == ["+aug", ("aug_k", 0.5), "-aug"]
    r1[at:at + 3] = ["-aug", "+aug", ("aug_k", 0.5)]
    run = _run(_marks(*_step(False), *r1, *_step(False), *_step(True)), 4,
               {"plain": 2, "r1": 2})
    for name in ("g_phase_ms_per_step", "d_phase_ms_per_step",
                 "aug_ms_per_step", "update_ms_per_step"):
        assert load_reader(name, ROOT)(run) is None
    assert load_reader("r1_step_ms", ROOT)(run) == pytest.approx(
        1e3 * (9.09375 + 20e-6))
