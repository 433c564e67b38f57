"""The whole step's share of the chip's peak: the FLOPs of the steps'
convolutions and matrix products (``counts/flops.py``, counted on the
reference step from the shapes, R1 steps at their own count) over the
traced window's seconds at the dense peak of the step's precision (TF32,
495 TFLOP/s, for float32 with cuDNN's TF32 convolutions; bf16, 989)."""

from benchmark.counts.flops import PEAK_FLOPS, step_flops


def read(run):
    ref = run["config"]["reference"]
    flops = sum(n * step_flops(ref, kind) for kind, n in run["kinds"].items())
    peak = PEAK_FLOPS["bf16" if run["dtype"] == "bf16" else "tf32"]
    return 100.0 * flops / (run["window_s"] * peak)
