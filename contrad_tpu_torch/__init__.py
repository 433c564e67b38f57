"""ContraD on PyTorch and CUDA for one NVIDIA H100.

The port of ``contrad_tpu`` (JAX on a TPU), module for module. It imports
``torch`` and never JAX or anything of ``contrad_tpu``; the JAX package stays
beside it as the reference that ``tests/test_torch_port_*.py`` hold it to.

Conventions shared by every module:
  * public functions take and return NHWC images, as the JAX package does,
    so the tests compare like with like;
  * randomness comes from explicit ``torch.Generator``s, and every random
    draw of the train step can also be passed in (the tests feed the draws
    JAX made);
  * a model's compute dtype (``get_architecture(..., dtype=)``) is what
    its layers cast their inputs and weights to; parameters stay float32
    masters, and the places the JAX package pins to float32 stay there
    (:func:`at_least_f32`);
  * entry points run on the card (``device="cuda"``) and raise when there is
    none, unless the caller asks for ``device="cpu"``. The hand-written CUDA
    kernels serve CUDA tensors; their plain PyTorch versions serve CPU
    tensors only.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` (the default) must exist;
    ``cpu`` is taken only when asked for. There is no silent fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return device
    if device.type == "cpu":
        return device
    raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own type where that is wider: the places
    where the JAX package computes in float32 (heads, losses, statistics)
    widen narrower inputs and keep a float64 run in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in the compute dtype ``dtype``; None, a float32 model's, leaves
    ``x`` in its own dtype (so a model made double computes in float64)."""
    return x if dtype is None else x.to(dtype)


def reduced_dtype(dtype: DtypeLike) -> Optional[torch.dtype]:
    """The dtype that a compute dtype or a storage lever names
    (``torch.float32``/``torch.bfloat16``, or the CLIs' ``f32``/``bf16``):
    bfloat16, or None for float32, where tensors keep the parameters' own
    dtype."""
    if isinstance(dtype, str):
        if dtype not in _DTYPE_NAMES:
            raise ValueError(f"unknown dtype {dtype!r}: use f32 or bf16")
        dtype = _DTYPE_NAMES[dtype]
    if dtype in (None, torch.float32):
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype {dtype}: use float32 or bfloat16")
    return dtype


_DTYPE_NAMES = {"f32": torch.float32, "bf16": torch.bfloat16}
DtypeLike = Union[str, torch.dtype, None]
