"""Named phases of the train step and spans of the loop around it, for a
``torch.profiler`` trace.

``phase(name, device)`` marks one of :data:`PHASES` on the device and spans
it on the host:

* on a CUDA device, always: an empty one-thread kernel on the current
  stream where the phase begins and another where it ends, named for the
  phase and the edge (``contrad_mark_g_begin``, ``contrad_mark_g_end``;
  ``csrc/marks.cu``, built with ``ops/nvcc.py`` at first use). Inside a
  CUDA graph's capture the marks become nodes of the graph, so every replay
  runs them in order between the phase's kernels and a device trace records
  them by name on the kernels' timeline: a host span cannot split a replay.
  The marks read and write no memory and allocate nothing. On the CPU a
  phase marks nothing.
* on the host, only while a profiler runs: a span ``contrad.<name>``. With
  none running, the host side costs one flag read and opens nothing.

``span(name)`` is the host side alone, for the pieces around the step:
``contrad.block.stage`` and ``contrad.block.replay`` (``training/graph.py``),
``contrad.graph.warmup`` and ``contrad.graph.capture``, ``contrad.loop.read``,
``contrad.loop.evaluate`` and ``contrad.loop.save`` (``utils/run.py``) and
``contrad.data.wait`` (``data/core.py``).

The phases, where they open (``training/step.py``, ``augment/__init__.py``):

  * ``step``: one whole ``train_step`` (its draws, the conversion, all below);
  * ``d``: one D update: the fakes' G forward where the update draws them,
    the mode's D loss and penalty, the backward;
  * ``r1``: R1's forward and its input gradient, inside ``d`` (its double
    backward runs in ``d``'s backward);
  * ``g``: the G update: G's forward, the G loss through D, the backward;
  * ``aug``: one forward application of an augment, the outermost only (the
    stages inside it add no marks); its backward runs in the enclosing
    phase's backward;
  * ``update``: an Adam update with D's spectral-norm ``u`` commit, and the
    EMA of G.

A kernel belongs to the innermost phase open where it starts
(``benchmark/harness/phases.py`` reads them so).

A host span is a profiler record function of the operators' scope, which the
trace keeps as a host operator (``cpu_op``) with its keyword ``args`` (shown
where the profiler records shapes). ``torch.profiler.record_function`` opens
one of the user scope instead, which the profiler also mirrors on the
device's timeline over every kernel launched inside it: a span around a
graph replay would read there as one kernel as long as the replay.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from contrad_tpu_torch.ops import nvcc

PHASES = ("step", "d", "r1", "g", "aug", "update")  # csrc/marks.cu's order
_SOURCE = nvcc.CSRC / "marks.cu"
_library = None  # the loaded ctypes library, built once per process


def mark_name(name: str, edge: str) -> str:
    """The kernel name of ``name``'s ``edge`` (``"begin"`` or ``"end"``)."""
    return f"contrad_mark_{name}_{edge}"


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/marks.cu`` (once per source hash) and load it; raises
    where its marks are not :data:`PHASES`' in order."""
    global _library
    if _library is None:
        lib = nvcc.build(_SOURCE, {
            "contrad_mark_count": ([], ctypes.c_int),
            "contrad_mark_name": ([ctypes.c_int], ctypes.c_char_p),
            "contrad_mark": ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                             ctypes.c_int)}, verbose)
        have = [lib.contrad_mark_name(i).decode()
                for i in range(lib.contrad_mark_count())]
        want = [mark_name(p, e) for p in PHASES for e in ("begin", "end")]
        if have != want:
            raise RuntimeError(f"csrc/marks.cu's marks {have} are not "
                               f"utils/trace.py's {want}")
        _library = lib
    return _library


def _mark(index: int, device: torch.device) -> None:
    stream = torch.cuda.current_stream(device)
    err = (_library or build()).contrad_mark(index, stream.device_index,
                                             stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase mark launch failed: CUDA error {err}")


@contextlib.contextmanager
def span(name: str, /, **args):
    """A host span ``name`` with keyword ``args`` while a profiler runs;
    else nothing."""
    if not _profiler._is_profiler_enabled:
        yield
        return
    with _RecordFunctionFast(name, [], args) if args else \
            _RecordFunctionFast(name):
        yield


@contextlib.contextmanager
def phase(name: str, device: torch.device):
    """Phase ``name`` of :data:`PHASES` on ``device`` (see the module
    docstring)."""
    index = 2 * PHASES.index(name)
    cuda = device.type == "cuda"
    with span(f"contrad.{name}"):
        if cuda:
            _mark(index, device)
        yield
        if cuda:
            _mark(index + 1, device)
