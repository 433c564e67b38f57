"""Ops of the port: the hand-written blur kernel (:mod:`.blur`) and the
plain PyTorch ops around it."""

from __future__ import annotations

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=None)
def device_constant(values: Tuple[float, ...], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``values`` as a 1-D tensor on ``device``, made once per values, dtype
    and device: a train step captured in a CUDA graph cannot copy from the
    host."""
    return torch.tensor(values, dtype=dtype, device=device)
