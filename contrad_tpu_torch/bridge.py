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
that port flips it at run time. The same rules carry the variants that no
registry architecture builds (``tests/test_torch_port_variants.py``): the
linear head of ``Discriminator(mlp_linear=False)`` (``linear/linear`` and
``linear/linear_y`` with their ``u``), and ``ResidualDiscriminator``'s and
``SkipDiscriminator``'s trees (``backbone``, ``block_<res>``, ``last_rgb``,
``last_conv``, the EqualDense ``fc1`` and ``fc2``).

:func:`adam_state_from_optax` turns an optax ``ScaleByAdamState`` (Adam's
``count``, ``mu`` and ``nu``, trees shaped as the parameters) into the
state ``ScheduledAdam.load_state_dict`` takes; bfloat16 moments are carried
bit for bit (every tensor keeps its dtype, bfloat16 included).

:func:`inception_state_from_jax` is the inverse of the JAX package's
``convert_torch_checkpoint`` for the FID InceptionV3: flax variables
(``params`` and ``batch_stats``) -> the checkpoint's keys, which the port's
``InceptionV3FID`` loads.
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


def _tensor(value: np.ndarray) -> torch.Tensor:
    """A writable, contiguous copy; float32 or wider, bfloat16 kept."""
    if value.dtype.name == "bfloat16":  # exact through float32
        return torch.from_numpy(np.ascontiguousarray(
            value, dtype=np.float32)).to(torch.bfloat16)
    dtype = np.result_type(value.dtype, np.float32)  # float64 stays
    return torch.from_numpy(np.array(value, dtype=dtype))


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
            out[".".join(names + [leaf])] = _tensor(value)
    return out


def adam_state_from_optax(adam_state, module: torch.nn.Module) -> dict:
    """An optax ``ScaleByAdamState`` whose ``mu`` and ``nu`` are trees of
    the JAX twin of ``module``'s parameters (numpy or JAX leaves) -> the
    ``ScheduledAdam.state_dict`` layout for ``module.parameters()``."""
    mu, nu = torch_state_dict(adam_state.mu), torch_state_dict(adam_state.nu)
    count = int(np.asarray(adam_state.count))
    names = [name for name, _ in module.named_parameters()]
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                 "exp_avg_sq": nu[name]} for i, name in enumerate(names)}
    return {"count": count,
            "adam": {"state": state,
                     "param_groups": [{"params": list(range(len(names)))}]}}


def inception_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax InceptionV3FID variables -> the ``pt_inception`` checkpoint's
    ``state_dict``: conv ``kernel`` HWIO -> ``weight`` OIHW; batch norm
    ``scale``, ``bias``, ``mean``, ``var`` -> ``weight``, ``bias``,
    ``running_mean``, ``running_var``; the fc's (in, out) ``kernel`` ->
    (out, in) ``weight``. Module names are kept."""
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean",
          "var": "running_var"}
    out = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, value in _flatten(tree).items():
            *names, leaf = path
            if names[-1] == "conv":
                leaf, value = "weight", value.transpose(3, 2, 0, 1)
            elif names[-1] == "bn":
                leaf = bn[leaf]
            elif leaf == "kernel":  # fc
                leaf, value = "weight", value.T
            out[".".join(names + [leaf])] = _tensor(value)
    return out
