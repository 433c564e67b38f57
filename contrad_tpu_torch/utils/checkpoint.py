"""Checkpoints and resume (the port of ``contrad_tpu/utils/checkpoint.py``).

One ``torch.save`` file per checkpoint, ``<logdir>/ckpt/<name>.pt``, holding
what the JAX package's train state holds: G, D and the EMA G with their
buffers (spectral norm's ``u``, G's batch-norm statistics), both optimiser
states (Adam's moments and the update count the warmup reads), the step, the
random stream (the device generator of the trainer's ``AugRng``) and the data
stream's epoch and position; and what the run is (``meta``: architecture
and number of classes), so that an evaluation CLI can rebuild its models.
Names:

  ckpt/latest.pt   - written at every evaluation (``--evaluate_every``)
  ckpt/best.pt     - written at an evaluation with the best FID so far
  ckpt/step_N.pt   - kept copies, every ``--save_every`` steps

A checkpoint is written under a temporary name in the same directory and
moved into place with ``os.replace``, so a kill in the middle of a write
leaves the previous file whole and at most a stale ``*.tmp`` beside it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

_TMP = ".tmp"


def ckpt_dir(logdir: str) -> str:
    return os.path.join(os.path.abspath(logdir), "ckpt")


def ckpt_path(logdir: str, name: str = "latest") -> str:
    return os.path.join(ckpt_dir(logdir), f"{name}.pt")


def save_checkpoint(logdir: str, state: Dict[str, Any],
                    name: str = "latest") -> str:
    """Write ``state`` as ``ckpt/<name>.pt`` atomically; returns its path."""
    path = ckpt_path(logdir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}{_TMP}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(logdir: str, name: str = "latest",
                       device: str | torch.device = "cpu") -> Dict[str, Any]:
    """The state saved as ``ckpt/<name>.pt``, its tensors on ``device``."""
    return torch.load(ckpt_path(logdir, name), map_location=device,
                      weights_only=True)


def has_checkpoint(logdir: str, name: str = "latest") -> bool:
    return os.path.isfile(ckpt_path(logdir, name))


def find_restorable(logdir: str) -> Optional[str]:
    """Name of the newest COMPLETED checkpoint under ``logdir``, or None.

    Temporaries of an interrupted write are skipped; of the completed files
    the newest by mtime wins, and ``latest`` wins a tie."""
    d = ckpt_dir(logdir)
    if not os.path.isdir(d):
        return None
    cands = []
    for f in os.listdir(d):
        path = os.path.join(d, f)
        if f.endswith(".pt") and os.path.isfile(path):
            name = f[:-len(".pt")]
            cands.append((os.path.getmtime(path), name == "latest", name))
    return max(cands)[2] if cands else None


def latest_step(logdir: str) -> Optional[int]:
    """The step of ``ckpt/latest.pt``, or None where there is none."""
    if not has_checkpoint(logdir):
        return None
    return int(restore_checkpoint(logdir)["step"])
