"""The bytes the blur kernel must move in a StyleGAN2 train step: every
launch of the step, its input and its output once each (the byte bound of a
launch; the kernel is bound by memory, not arithmetic).

Per G forward: one blur after each upsampling transposed conv, on its
(2s + 1)-square output, pads (1, 1), taps x4; per D forward: two per
residual block, before the stride-2 3x3 conv (pads (2, 2)) and before the
stride-2 1x1 skip (pads (1, 1)), on the block's input. Each forward launch
has an adjoint launch in the backward: the gradient's shape, pads
(3 - pad0, 3 - pad1). A step runs G once (G phase), D at 3 x batch (the
contrastive D pass) and at batch (the G phase), and with R1 D twice more
each way at batch (R1's pass and its double backward)."""

from __future__ import annotations

from typing import Dict, List, Tuple

Launch = Tuple[Tuple[int, int, int, int], Tuple[int, int], int, Dict[str, int]]


def launches(model: Dict, batch: int) -> List[Launch]:
    """(input shape NHWC, pads, upsample factor, launches a step by kind
    ``plain`` and ``r1``) of every blur of the step."""
    ch = {int(k): v for k, v in model["channels"].items()}
    size = model["image_size"]
    fwd = []
    s = 4
    while 2 * s <= size:
        fwd.append(((batch, 2 * s + 1, 2 * s + 1, ch[2 * s]), (1, 1), 2,
                    {"plain": 1, "r1": 1}))
        s *= 2
    for n, plain, r1 in ((3 * batch, 1, 1), (batch, 1, 3)):
        s = size
        while s > 4:
            for pad in ((2, 2), (1, 1)):
                fwd.append(((n, s, s, ch[s]), pad, 1,
                            {"plain": plain, "r1": r1}))
            s //= 2
    adj = [((n, h + sum(pad) - 3, w + sum(pad) - 3, c),
            (3 - pad[0], 3 - pad[1]), up, per)
           for (n, h, w, c), pad, up, per in fwd]
    return fwd + adj


def launch_bytes(shape, pad, itemsize: int = 4) -> int:
    """Input and output of one launch, once each."""
    n, h, w, c = shape
    ho, wo = h + sum(pad) - 3, w + sum(pad) - 3
    return itemsize * n * c * (h * w + ho * wo)


def step_bytes(model: Dict, batch: int, kind: str, itemsize: int = 4) -> int:
    return sum(per[kind] * launch_bytes(shape, pad, itemsize)
               for shape, pad, _, per in launches(model, batch))


def step_launches(model: Dict, batch: int, kind: str) -> int:
    return sum(per[kind] for _, _, _, per in launches(model, batch))
