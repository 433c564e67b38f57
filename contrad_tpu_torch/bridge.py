"""JAX parameter trees -> the port's ``state_dict``s.

Takes the flax ``params`` tree of a ``contrad_tpu`` StyleGAN2 G or D as
nested dicts of numpy arrays and returns ``{name: torch.Tensor}`` for
``module.load_state_dict``. The same mapping converts gradient trees, which
share the parameters' structure. Rules:
  * module names: ``style_3`` -> ``style.3``, ``layers_0`` -> ``layers.0``,
    ``to_rgbs_1`` -> ``to_rgbs.1`` (``nn.ModuleList``s); others keep theirs;
  * conv weights: HWIO -> OIHW. Raw equalised-lr parameters are kept raw:
    both packages apply the runtime scale in the forward;
  * ``EqualDense.weight`` and the heads' ``kernel``: (in, out) -> (out, in),
    and ``kernel`` is renamed ``weight``;
  * ``ConstantInput.const`` (1, 4, 4, C), ToRGB's (1, 1, 1, 3) bias and the
    noise scalars keep their NHWC shapes: the port is NHWC inside.
The upsampling ModulatedConv's kernel is converted like any conv; the port
flips it at run time, because ``jax.lax.conv_transpose`` does not flip its
kernel and ``torch.conv_transpose2d`` does.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LISTS = re.compile(r"^(style|layers|to_rgbs)_(\d+)$")


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
    if value.ndim == 4 and leaf == "weight":  # HWIO conv kernel
        return "weight", value.transpose(3, 2, 0, 1)
    if value.ndim == 2 and leaf in ("weight", "kernel"):  # (in, out) dense
        return "weight", value.T
    return leaf, value


def torch_state_dict(jax_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (numpy leaves) -> the port's ``state_dict``."""
    out = {}
    for path, value in _flatten(jax_params).items():
        names = [_LISTS.sub(r"\1.\2", p) for p in path[:-1]]
        leaf, value = _convert(path, value)
        dtype = np.result_type(value.dtype, np.float32)  # float64 stays
        out[".".join(names + [leaf])] = torch.from_numpy(
            np.array(value, dtype=dtype))  # a writable, contiguous copy
    return out
