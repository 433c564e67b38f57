"""The work of StyleGAN3's filtered leaky ReLU kernel in a train step, from
the shapes alone: its bytes and its multiply-adds, and the roofline time
of each launch. Where the step runs it, and at which shapes, is its model
family's table (``filtered_lrelu_launches`` in ``reference/families/``,
read with ``getattr``: a family without one runs no such kernel). A row is
``(op, in NHWC, out NHWC, grid (h, w), up, down, taps up, taps down,
launches a step by kind plain and r1)``, as the kernel sees the launch (the
backward's ``in`` is ``dy``, its ``out`` ``dx``).

* Bytes: the input, the output, the forward's ``(C,)`` bias and the sign
  words (two bits a value of the upsampled grid, 16 bits a group of 8
  channels: written forward, read backward), once each.
* Multiply-adds: the separable polyphase computation on the grid, per
  image and channel: upsampling along x (each input row to the grid's
  columns, ``taps up / up`` each), along y (every grid value), then
  downsampling along y (each output row of the grid's columns, ``taps
  down`` each) and along x (every output). No halo: the tiles' overlap is
  the kernel's own cost.
* The roofline time of a launch: the larger of its bytes at 3.35 TB/s and
  its multiply-adds, two flops each, at the FP32 peak (67 TFLOP/s, H100
  SXM: the kernel's arithmetic is float32 FMAs, not tensor cores)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.counts.flops import HBM_BYTES_PER_S

FP32_FLOPS_PER_S = 67e12
GROUP = 8  # channels a sign word

Launch = Tuple[str, Tuple[int, int, int, int], Tuple[int, int, int, int],
               Tuple[int, int], int, int, int, int, Dict[str, int]]


def launches(model: Dict, batch: int) -> List[Launch]:
    """Every launch of the kernel in a step of the configuration's ``model``
    table at ``batch``; none for a family that does not run it."""
    from benchmark.reference.families import make_model

    table = getattr(make_model(model), "filtered_lrelu_launches", None)
    return [] if table is None else table(batch)


def launch_bytes(row: Launch, itemsize: int = 4) -> int:
    op, x, y, (gh, gw) = row[:4]
    n, c = x[0], x[3]
    values = n * c * (x[1] * x[2] + y[1] * y[2]) + (c if op == "forward" else 0)
    return itemsize * values + 2 * n * (-(-c // GROUP)) * gh * gw


def launch_macs(row: Launch) -> int:
    _, x, y, (gh, gw), up, _, taps_up, taps_down = row[:8]
    n, h_in, _, c = x
    h_out, w_out = y[1], y[2]
    plane = (h_in * gw + gh * gw) * (taps_up // up) + (
        h_out * gw + h_out * w_out) * taps_down
    return n * c * plane


def launch_seconds(row: Launch, itemsize: int = 4) -> float:
    return max(launch_bytes(row, itemsize) / HBM_BYTES_PER_S,
               2 * launch_macs(row) / FP32_FLOPS_PER_S)


def step_seconds(model: Dict, batch: int, kind: str,
                 itemsize: int = 4) -> float:
    """The roofline time of a step of ``kind``'s launches."""
    return sum(row[-1][kind] * launch_seconds(row, itemsize)
               for row in launches(model, batch))


def step_launches(model: Dict, batch: int, kind: str) -> int:
    return sum(row[-1][kind] for row in launches(model, batch))
