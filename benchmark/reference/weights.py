"""The weights of a run, made on the device from its seed in a few large
calls, by each entry's initialisation in its family's spec
(``families/``): N(0, 0.02) for SNDCGAN's layers and heads; N(0, 1) for
StyleGAN2's convs, scaled at run time, and N(0, 100) for its style MLP
(lr_mul 0.01); lecun-normal for StyleGAN2's heads (variance 1 / fan_in,
clipped at two deviations); biases, noise strengths and batch norm's
shifts 0, its scales 1; spectral norm's ``u`` a unit vector. Every drawn
entry is a slice of one normal draw, in spec order; an entry of a kind of
the family's own (a filter, fixed frequencies, uniform phases) is made by
the family from a generator on a stream of its own, in spec order, so
that it moves no other entry's draw."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.draws import derive
from benchmark.reference.families import make_model

WEIGHTS_STREAM = 1
MADE_STREAM = 3  # (2 is the images')
DRAWN = ("normal", "trunc", "unit")


def make_weights(model_cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """``{"generator": {...}, "discriminator": {...}}``, name -> float32
    tensor, as the program's ``state_dict`` names them."""
    model = make_model(model_cfg)
    parts = {"generator": model.g_spec(), "discriminator": model.d_spec()}
    drawn = [s for spec in parts.values() for s in spec if s[2][0] in DRAWN]
    total = sum(_numel(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, WEIGHTS_STREAM))
    flat = torch.randn(total, generator=gen, device=device)
    made = None
    out, at = {}, 0
    for part, spec in parts.items():
        out[part] = {}
        for name, shape, init in spec:
            kind = init[0]
            if kind == "zeros":
                w = torch.zeros(shape, device=device)
            elif kind == "ones":
                w = torch.ones(shape, device=device)
            elif kind in DRAWN:
                n = _numel(shape)
                w = flat[at:at + n].view(shape).clone()
                at += n
                if kind == "normal":
                    w.mul_(init[1])
                elif kind == "trunc":
                    w.clamp_(-2.0, 2.0).mul_(init[1] / 0.87962566103423978)
                else:  # unit
                    w.div_(torch.linalg.vector_norm(w) + 1e-12)
            else:
                if made is None:
                    made = torch.Generator(device=device)
                    made.manual_seed(derive(seed, MADE_STREAM))
                w = model.make(name, tuple(shape), init, made).to(
                    device=device, dtype=torch.float32)
                if tuple(w.shape) != tuple(shape):
                    raise ValueError(f"{name}: made {tuple(w.shape)}, the "
                                     f"spec says {tuple(shape)}")
            out[part][name] = w
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
