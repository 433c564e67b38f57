"""Dataset registry (the ``cifar10[_hflip]`` and ``synthetic*`` branches of
``contrad_tpu/data/__init__.py``).

``get_dataset(name)`` -> ``(train, test, image_size)`` as uint8 NHWC
:class:`ArrayDataset`s. ``$DATA_DIR`` points at the data root.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from contrad_tpu_torch.data.cifar import load_cifar10
from contrad_tpu_torch.data.core import ArrayDataset, DeviceBatchIterator
from contrad_tpu_torch.data.synthetic import synthetic_dataset

DATA_PATH = os.environ.get("DATA_DIR", "data/")

Entry = Tuple[ArrayDataset, Optional[ArrayDataset], Tuple[int, int, int]]


def get_dataset(dataset: str, data_path: Optional[str] = None) -> Entry:
    root = data_path or DATA_PATH

    if dataset in ("cifar10", "cifar10_hflip"):
        train, test = load_cifar10(root)
        if dataset.endswith("_hflip"):
            train.train_aug = "hflip"  # DiffAug recipe (datasets.py:49-69)
        return train, test, (32, 32, 3)

    if dataset.startswith("synthetic"):
        # synthetic[_<size>[_<ntrain>]]: procedural data for smoke runs.
        parts = dataset.split("_")
        size = int(parts[1]) if len(parts) > 1 else 32
        n_train = int(parts[2]) if len(parts) > 2 else 2048
        n_test = max(512, min(n_train // 5, 10000))
        class_signal = len(parts) > 2
        image_size = (size, size, 3)
        train = synthetic_dataset(image_size, n=n_train, seed=0,
                                  class_signal=class_signal)
        test = synthetic_dataset(image_size, n=n_test, seed=1,
                                 class_signal=class_signal)
        return train, test, image_size

    raise NotImplementedError(f"unknown dataset: {dataset}")


__all__ = ["ArrayDataset", "DeviceBatchIterator", "get_dataset",
           "synthetic_dataset", "DATA_PATH"]
