"""The evaluation's state across ``--resume`` (the port of
``contrad_tpu/evaluate/persist.py``), in the JAX package's layout, so that
either package restores the other's run directory.

The train state lives in ``ckpt/``; this sidecar carries the evaluation's
trackers, which the reference loses on ``--resume``
(``evaluate/gan.py:48-58, 147-159``): the FID history and best so far (so
that the ``ckpt/best`` gate survives a restart instead of being overwritten
by the first score after it), the fixed GIF latents and the frames so far
(one continuous progress GIF), and ``eval_seed``, the suffix of the CSV and
GIF names (so that they go on growing instead of forking at each restart).

``eval_state.npz`` beside ``ckpt/``, written atomically at each evaluation,
holds ``eval_seed``, ``fid_*`` (the tracker's ``state_dict``) and ``gif_*``
(the latents and the frame count). The frames never change once recorded,
so each is one ``.npy`` under ``eval_gif_frames/``, written ONCE: writing
the whole stack at each evaluation would cost O(evals^2) bytes over a run.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

FILENAME = "eval_state.npz"
FRAMES_DIR = "eval_gif_frames"


def _path(logdir: str) -> str:
    return os.path.join(logdir, FILENAME)


def _frames_dir(logdir: str) -> str:
    return os.path.join(logdir, FRAMES_DIR)


def _frame_path(logdir: str, i: int) -> str:
    return os.path.join(_frames_dir(logdir), f"{i:06d}.npy")


def save_eval_state(logdir: str, eval_seed: int, fid=None,
                    fixed_gen=None) -> str:
    payload = {"eval_seed": np.int64(eval_seed)}
    if fid is not None:
        for k, v in fid.state_dict().items():
            payload[f"fid_{k}"] = v
    if fixed_gen is not None:
        sd = fixed_gen.state_dict()
        frames = sd.pop("frames", None)
        for k, v in sd.items():
            payload[f"gif_{k}"] = v
        if frames is not None:
            payload["gif_n_frames"] = np.int64(len(frames))
            fdir = _frames_dir(logdir)
            os.makedirs(fdir, exist_ok=True)
            for i, frame in enumerate(frames):
                fp = _frame_path(logdir, i)
                if not os.path.exists(fp):  # immutable: write each once
                    tmp = fp + ".tmp.npy"
                    np.save(tmp, np.asarray(frame))
                    os.replace(tmp, fp)
            for name in os.listdir(fdir):  # drop files beyond the count —
                stem = name.split(".")[0]  # they'd block write-once later
                if name.endswith(".npy") and stem.isdigit() \
                        and int(stem) >= len(frames):
                    os.remove(os.path.join(fdir, name))
    path = _path(logdir)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)  # atomic: a crash mid-write never corrupts resume
    return path


def _load_frames(logdir: str, n: int) -> np.ndarray:
    """The contiguous prefix of persisted frames up to the npz's count; any
    later files (a resume rolled the run back past them) are stale — drop
    them so the write-once invariant holds for the frames about to be
    re-recorded."""
    frames = []
    for i in range(n):
        fp = _frame_path(logdir, i)
        if not os.path.exists(fp):
            break
        frames.append(np.load(fp))
    fdir = _frames_dir(logdir)
    if os.path.isdir(fdir):
        for name in os.listdir(fdir):
            stem = name.split(".")[0]
            if name.endswith(".npy") and stem.isdigit() \
                    and int(stem) >= len(frames):
                os.remove(os.path.join(fdir, name))
    return (np.stack(frames) if frames else np.zeros((0,), dtype=np.uint8))


def restore_eval_state(logdir: str, fid=None, fixed_gen=None) -> Optional[int]:
    """Load the sidecar into the given trackers (each optional). Returns the
    persisted eval_seed, or None when no sidecar exists (fresh run / resume
    of a pre-sidecar logdir — trackers stay fresh, matching the reference)."""
    path = _path(logdir)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        if fid is not None and "fid_history" in d:
            fid.load_state_dict(
                {k[len("fid_"):]: d[k] for k in d.files
                 if k.startswith("fid_")})
        if fixed_gen is not None and "gif_z" in d:
            sd = {k[len("gif_"):]: d[k] for k in d.files
                  if k.startswith("gif_")}
            n = int(sd.pop("n_frames", -1))
            if n >= 0:  # per-frame files; pre-round-3 sidecars inline them
                sd["frames"] = _load_frames(logdir, n)
            fixed_gen.load_state_dict(sd)
        return int(d["eval_seed"])
