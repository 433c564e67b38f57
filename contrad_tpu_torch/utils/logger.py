"""Run-directory logger (the port of ``contrad_tpu/utils/logger.py``;
reference ``utils.py:15-74``).

A run writes into ``<root>/<subdir>/<run name>/<rand>``, the train CLIs'
``<root>/gan/<config stem>/<architecture>/<run name>/<rand>``: ``log.txt``
(each line with a timestamp), ``scalars.jsonl`` (one
``{"tag", "value", "step"}`` object a line, under the JAX package's tag
names such as ``gan/train/G_loss``) and, where ``tensorboardX`` imports,
TensorBoard events under the same tags. Without it the logger says so once
in ``log.txt``. ``resume=`` reuses an existing directory.
:func:`append_csv` keeps a CSV such as the FID results, one row per call.
"""

from __future__ import annotations

import csv
import json
import os
import sys
from datetime import datetime
from typing import Optional

import numpy as np


class Logger:
    def __init__(self, fn: Optional[str], subdir: Optional[str] = None,
                 resume: Optional[str] = None, root: str = "logs",
                 rand: Optional[int] = None):
        if resume:
            logdir = resume
            if not os.path.isdir(logdir):
                raise OSError(f"logdir does not exist: {logdir}")
        else:
            if subdir is None:
                subdir = datetime.today().strftime("%y%m%d")
            if rand is None:
                rand = int(np.random.default_rng().integers(10000))
            logdir = os.path.join(root, subdir, fn or "run", str(rand))
            os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._writer = None
        self.log_file = open(os.path.join(logdir, "log.txt"), "a")

    @property
    def writer(self):
        if self._writer is None:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(self.logdir)
            except Exception as e:  # optional: scalars.jsonl has every scalar
                self._writer = False
                msg = (f"tensorboardX unavailable ({type(e).__name__}: {e}); "
                       f"scalars will be written to scalars.jsonl only")
                print(f"[logger] {msg}", file=sys.stderr)
                self.log_file.write(f"[logger] {msg}\n")
                self.log_file.flush()
        return self._writer

    def log(self, string: str) -> None:
        line = f"[{datetime.now()}] {string}"
        self.log_file.write(line + "\n")
        self.log_file.flush()
        print(line, flush=True)

    def log_dirname(self, string: str) -> None:
        line = f"{string} ({self.logdir})"
        self.log_file.write(line + "\n")
        self.log_file.flush()
        print(line, flush=True)

    def scalar_summary(self, tag: str, value, step: int) -> None:
        value = float(value)
        if self.writer:
            self.writer.add_scalar(tag, value, step)
        with open(os.path.join(self.logdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "value": value,
                                "step": int(step)}) + "\n")

    def close(self) -> None:
        if self._writer:
            self._writer.close()
        self.log_file.close()


class RankLogger:
    """The logger of a rank other than 0 in a world of processes: the run
    directory is rank 0's, and only rank 0 writes there (the reference's
    rank gating, ``train_gan.py:192-225``), so this one writes and prints
    nothing."""

    def __init__(self, logdir: str):
        self.logdir = logdir

    def log(self, string: str) -> None:
        pass

    log_dirname = log

    def scalar_summary(self, tag: str, value, step: int) -> None:
        pass

    def close(self) -> None:
        pass


def append_csv(path: str, header, row) -> None:
    """Append ``row`` to the CSV at ``path``, writing ``header`` first where
    the file is new (reference ``evaluate/gan.py:147-159``)."""
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)
