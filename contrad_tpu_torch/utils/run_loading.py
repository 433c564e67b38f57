"""Load a training run back from its logdir (the port of
``contrad_tpu/utils/run_loading.py``): the config the run left there and a
checkpoint (reference eval scripts, ``test_lineval.py:117-144``,
``test_gan_sample_cddls.py:292-305``)."""

from __future__ import annotations

import copy
import glob
import os
from typing import Optional, Tuple

import torch
from torch import nn

from contrad_tpu_torch import resolve_device
from contrad_tpu_torch.config import (
    Config, default_config_files, finalize_options, load_config)
from contrad_tpu_torch.data import get_image_size
from contrad_tpu_torch.models import Discriminator, get_architecture
from contrad_tpu_torch.utils.checkpoint import (
    has_checkpoint, restore_checkpoint)


def discover_config(logdir: str) -> str:
    candidates = sorted(glob.glob(os.path.join(logdir, "*.toml")))
    if not candidates:
        raise FileNotFoundError(f"no config.toml found in {logdir}")
    return candidates[0]


def load_run(logdir: str, architecture: str, ckpt: str = "latest",
             device: str | torch.device = "cuda"
             ) -> Tuple[Config, nn.Module, Discriminator, Optional[nn.Module],
                        Tuple[int, int, int]]:
    """Returns ``(cfg, G, D, G_ema, image_size)`` on ``device``, restored
    from ``ckpt/<ckpt>.pt``; ``G_ema`` is None where the run keeps no EMA.
    D is built with the run's number of classes. The run's dataset need
    not be present: only its image size is read."""
    device = resolve_device(device)
    cfg = finalize_options(load_config(default_config_files(
        discover_config(logdir))))
    image_size = get_image_size(cfg.options.dataset)
    if not has_checkpoint(logdir, ckpt):
        raise FileNotFoundError(f"no '{ckpt}' checkpoint under {logdir}/ckpt")
    state = restore_checkpoint(logdir, ckpt, device)
    if state["meta"]["architecture"] != architecture:
        raise ValueError(f"{logdir} trained {state['meta']['architecture']}, "
                         f"not {architecture}")
    generator, discriminator = get_architecture(
        architecture, image_size, device=device,
        n_classes=state["meta"]["n_classes"])
    generator.load_state_dict(state["generator"])
    discriminator.load_state_dict(state["discriminator"])
    g_ema = None
    if state["g_ema"] is not None:
        g_ema = copy.deepcopy(generator)
        g_ema.load_state_dict(state["g_ema"])
    for module in (generator, discriminator, g_ema):
        if module is not None:
            module.requires_grad_(False)
    return cfg, generator, discriminator, g_ema, image_size
