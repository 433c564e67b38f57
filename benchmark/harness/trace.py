"""The device trace of a traced window, from ``torch.profiler`` (CUPTI):
every kernel, copy and set on the card with its start and end, the host's
operators and runtime calls beside them, and what is read from them: busy
time as the union of the device's intervals (kernels that overlap count
once), kernel time by name and by class, and the idle gaps by what the host
was doing."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

WINDOW = "benchmark.window"
SHORT_GAP_S = 20e-6
SHORT_GAP = "(gaps under 20 us between kernels)"
# the kernels a traced window's lead-in launches before it, left out of it
LEAD_IN = 256
LEAD_IN_KERNEL = "spin_kernel"

# A kernel's class, by the first rule whose key its name holds (the port's
# kernels on the H100: cuDNN, cuBLAS/CUTLASS, PyTorch's own).
CLASSES = (
    ("blur", ("blur2d_kernel",)),
    ("layout transpose", ("nchwtonhwc", "nhwctonchw")),
    ("batch norm", ("batch_norm", "batchnorm", "welford")),
    ("convolution", ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm",
                     "xmma_fprop", "cudnn")),
    ("matmul", ("gemm", "gemv", "cublas", "cutlass", "sm90_xmma")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("copy", ("copy", "cat", "transpose", "permute", "memcpy", "memset")),
    ("reduction", ("reduce", "norm", "softmax", "argmax", "sum")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "index")),
)


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in CLASSES:
        if any(k in n for k in keys):
            return cls
    return "other"


@dataclasses.dataclass
class Trace:
    """Times in seconds from the window's start."""

    window_s: float
    device: List[Tuple[str, float, float]]  # (name, start, end)
    host: List[Tuple[str, float, float]]
    lead_in: int = 0  # the lead-in's kernels that the profiler kept

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy(self) -> List[Tuple[float, float]]:
        """The device's busy intervals, merged."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def by_name(self) -> Dict[str, List[float]]:
        """Kernel name -> [seconds, launches]."""
        out: Dict[str, List[float]] = {}
        for name, s, e in self.kernels():
            row = out.setdefault(name, [0.0, 0])
            row[0] += e - s
            row[1] += 1
        return out

    def class_seconds(self, cls: str) -> float:
        return sum(e - s for name, s, e in self.kernels()
                   if kernel_class(name) == cls)

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds by what the host was doing: gaps shorter than
        ``SHORT_GAP_S`` (a dependent kernel's launch inside a graph) in one
        row; each longer gap by the host operator or runtime call running
        at its middle (the innermost one)."""
        gaps, at = [], 0.0
        for s, e in self.busy():
            if s > at:
                gaps.append((at, s))
            at = e
        if at < self.window_s:
            gaps.append((at, self.window_s))
        host = sorted((h for h in self.host if h[0] != WINDOW),
                      key=lambda x: x[1])
        out: Dict[str, float] = {}
        active, i = [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            if e - s < SHORT_GAP_S:
                name = SHORT_GAP
            else:
                mid = 0.5 * (s + e)
                while i < len(host) and host[i][1] <= mid:
                    active.append(host[i])
                    i += 1
                active = [h for h in active if h[2] >= mid]
                name = (min(active, key=lambda h: h[2] - h[1])[0] if active
                        else "(host outside any operator)")
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(((n, v[0]) for n, v in self.by_name().items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event the profiler
    kept: the raw results where this PyTorch has them, else its parsed
    events."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None and hasattr(results, "events"):
        for ev in results.events():
            start = ev.start_ns() if hasattr(ev, "start_ns") else \
                1000 * ev.start_us()
            dur = ev.duration_ns() if hasattr(ev, "duration_ns") else \
                1000 * ev.duration_us()
            yield (ev.name(), ev.device_type() == DeviceType.CUDA, start,
                   start + dur)
        return
    for ev in prof.events():
        yield (ev.name, ev.device_type == DeviceType.CUDA,
               1000 * ev.time_range.start, 1000 * ev.time_range.end)


def window_trace(events, window_s: float) -> Trace:
    """The trace of the window from the profiler's events (``(name,
    is_device, start_ns, end_ns)``): times from the window annotation's
    start, scaled to the host clock's ``window_s``; the lead-in's kernels
    (``LEAD_IN_KERNEL``) and host events that end before the window left
    out."""
    events = list(events)
    marks = [(s, e) for name, dev, s, e in events
             if name == WINDOW and not dev]
    if not marks:
        raise RuntimeError("the trace holds no window annotation")
    start, end = marks[0]
    scale = window_s / max((end - start) * 1e-9, 1e-12)
    to_s = lambda ns: (ns - start) * 1e-9 * scale  # noqa: E731
    # the window's annotation is mirrored on the device's timeline: not work
    device = [(n, to_s(s), to_s(e)) for n, dev, s, e in events
              if dev and n != WINDOW]
    kept = [d for d in device if LEAD_IN_KERNEL not in d[0]]
    host = [(n, to_s(s), to_s(e)) for n, dev, s, e in events
            if not dev and e > start]
    return Trace(window_s, kept, host, len(device) - len(kept))


def lead_in(sync: Callable[[], None]) -> None:
    """``LEAD_IN`` empty kernels (``torch.cuda._sleep``), then a wait: CUPTI
    can lose the first kernel records of a profiling session (on the H100,
    0-7 of a session's first kernels, more in later sessions of a process),
    and these take the loss in the window's place."""
    import torch

    for _ in range(LEAD_IN):
        torch.cuda._sleep(1)
    sync()


def record(work: Callable[[], None], sync: Callable[[], None],
           card: bool = True) -> Trace:
    """Run ``work`` under the profiler between two synchronisations, on the
    ``card`` after a lead-in (``lead_in``); returns its trace, whose window
    is the host clock's."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if card:
            lead_in(sync)
        with record_function(WINDOW):
            t0 = time.perf_counter()
            work()
            sync()
            window_s = time.perf_counter() - t0
    return window_trace(_events(prof), window_s)
