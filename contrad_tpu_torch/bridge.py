"""JAX variable trees -> the port's ``state_dict``s.

Takes the flax ``params`` tree of a ``contrad_tpu`` G or D (StyleGAN2 or
SNDCGAN) as nested dicts of numpy arrays, and optionally its mutable
collections (``batch_stats``, ``spectral``), and returns
``{name: torch.Tensor}`` for ``module.load_state_dict``, so that both
packages start from the same state. The same mapping converts gradient
trees, which share the parameters' structure. Rules:
  * module names: ``style_3`` -> ``style.3``, ``layers_0`` -> ``layers.0``,
    ``to_rgbs_1`` -> ``to_rgbs.1`` (``nn.ModuleList``s); others keep theirs;
  * conv weights (4-D ``weight`` or ``kernel``): HWIO -> OIHW, named
    ``weight``. Raw equalised-lr parameters are kept raw: both packages
    apply the runtime scale in the forward;
  * SNDCGAN's conv-transpose kernels (4-D ``kernel`` of a module ``up<i>``):
    flipped in both spatial axes HERE, then (kH, kW, in, out) ->
    (in, out, kH, kW), torch's conv-transpose layout, because
    ``jax.lax.conv_transpose`` does not flip its kernel and
    ``torch.conv_transpose2d`` does. The port's module holds the flipped
    kernel and flips nothing at run time;
  * ``EqualDense.weight`` and dense ``kernel``s: (in, out) -> (out, in),
    named ``weight``;
  * ``SNEmbed``'s (classes, features) ``embedding`` (a conditional D's
    ``linear/linear_y``) -> ``weight``, as it is;
  * batch norm: ``scale`` -> ``weight``; ``batch_stats`` ``mean`` / ``var``
    -> ``running_mean`` / ``running_var``; spectral norm's ``u`` keeps its
    name (a buffer of each layer);
  * ``ConstantInput.const`` (1, 4, 4, C), ToRGB's (1, 1, 1, 3) bias and the
    noise scalars keep their NHWC shapes: the StyleGAN2 port is NHWC inside.
The StyleGAN2 upsampling ModulatedConv's kernel is converted like any conv;
that port flips it at run time.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LISTS = re.compile(r"^(style|layers|to_rgbs)_(\d+)$")
_CONV_TRANSPOSE = re.compile(r"^up\d+$")
_RENAME = {"scale": "weight", "embedding": "weight", "mean": "running_mean",
           "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convert(path: tuple, value: np.ndarray):
    leaf = path[-1]
    if value.ndim == 4 and leaf == "kernel" and len(path) > 1 \
            and _CONV_TRANSPOSE.match(path[-2]):
        return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
    if value.ndim == 4 and leaf in ("weight", "kernel"):  # HWIO conv kernel
        return "weight", value.transpose(3, 2, 0, 1)
    if value.ndim == 2 and leaf in ("weight", "kernel"):  # (in, out) dense
        return "weight", value.T
    return _RENAME.get(leaf, leaf), value


def torch_state_dict(jax_params: Mapping, jax_state: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (numpy leaves), and optionally the mutable
    collections ``{'batch_stats': ..., 'spectral': ...}``, -> the port's
    ``state_dict``."""
    out = {}
    for tree in [jax_params, *(jax_state or {}).values()]:
        for path, value in _flatten(tree).items():
            names = [_LISTS.sub(r"\1.\2", p) for p in path[:-1]]
            leaf, value = _convert(path, value)
            dtype = np.result_type(value.dtype, np.float32)  # float64 stays
            out[".".join(names + [leaf])] = torch.from_numpy(
                np.array(value, dtype=dtype))  # a writable, contiguous copy
    return out
