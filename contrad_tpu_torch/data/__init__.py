"""Dataset registry (the port of ``contrad_tpu/data/__init__.py`` for
``cifar10[_hflip|_lin]``, ``cifar100[_hflip|_lin]``, ``celeba128``,
``afhq_{cat,dog,wild}`` and ``synthetic*``).

``get_dataset(name)`` -> ``(train, test, image_size)`` as uint8 NHWC
:class:`ArrayDataset`s; ``get_image_size(name)`` gives the image shape
without loading anything; ``get_dataset_ref(name)`` is the split FID's
reference statistics are taken on. ``$DATA_DIR`` points at the data root. A
dataset's ``train_aug`` names the augmentation the reference baked into its
transforms (``hflip`` for the ``_hflip`` variants and AFHQ, ``lin`` for the
linear probe's ``_lin`` variants: RRC(0.2, 1) + flip); the trainers and the
probe apply it on the device.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from contrad_tpu_torch.data.cifar import load_cifar10, load_cifar100
from contrad_tpu_torch.data.core import (
    ArrayDataset, BatchIterator, DeviceBatchIterator, PrefetchIterator,
    ShardedDeviceBatchIterator, make_train_loader)
from contrad_tpu_torch.data.folder import load_image_folder
from contrad_tpu_torch.data.synthetic import synthetic_dataset

DATA_PATH = os.environ.get("DATA_DIR", "data/")

Entry = Tuple[ArrayDataset, Optional[ArrayDataset], Tuple[int, int, int]]

_AFHQ = ("afhq_cat", "afhq_dog", "afhq_wild")
_CIFAR = ("cifar10", "cifar10_hflip", "cifar10_lin", "cifar100",
          "cifar100_hflip", "cifar100_lin")


def get_image_size(dataset: str) -> Tuple[int, int, int]:
    """Image shape of a dataset, without loading it."""
    if dataset in _CIFAR:
        return (32, 32, 3)
    if dataset == "celeba128":
        return (128, 128, 3)
    if dataset in _AFHQ:
        return (512, 512, 3)
    if dataset.startswith("synthetic"):
        parts = dataset.split("_")
        size = int(parts[1]) if len(parts) > 1 else 32
        return (size, size, 3)
    raise NotImplementedError(f"unknown dataset: {dataset}")


def get_dataset(dataset: str, data_path: Optional[str] = None) -> Entry:
    root = data_path or DATA_PATH

    if dataset in _CIFAR:
        loader = load_cifar100 if dataset.startswith("cifar100") else load_cifar10
        train, test = loader(root)
        if dataset.endswith("_hflip"):
            train.train_aug = "hflip"  # DiffAug recipe (datasets.py:49-69)
        elif dataset.endswith("_lin"):
            train.train_aug = "lin"  # linear eval's RRC + flip (datasets.py:23-47)
        return train, test, (32, 32, 3)

    if dataset == "celeba128":
        image_size = get_image_size(dataset)
        split = os.path.join(root, "CelebAMask-HQ", "CelebA-128-split")
        return (load_image_folder(os.path.join(split, "train"), image_size),
                load_image_folder(os.path.join(split, "test"), image_size),
                image_size)

    if dataset in _AFHQ:
        image_size = get_image_size(dataset)
        kind = dataset.split("_", 1)[1]
        train = load_image_folder(os.path.join(root, "afhq", kind, "train"),
                                  image_size)
        train.train_aug = "hflip"  # reference datasets.py:83-126
        val = load_image_folder(os.path.join(root, "afhq", kind, "val"),
                                image_size)
        return train, val, image_size

    if dataset.startswith("synthetic"):
        # synthetic[_<size>[_<ntrain>]]: procedural data for smoke runs.
        parts = dataset.split("_")
        n_train = int(parts[2]) if len(parts) > 2 else 2048
        n_test = max(512, min(n_train // 5, 10000))
        class_signal = len(parts) > 2
        image_size = get_image_size(dataset)
        train = synthetic_dataset(image_size, n=n_train, seed=0,
                                  class_signal=class_signal)
        test = synthetic_dataset(image_size, n=n_test, seed=1,
                                 class_signal=class_signal)
        return train, test, image_size

    raise NotImplementedError(f"unknown dataset: {dataset}")


def get_dataset_ref(dataset: str, data_path: Optional[str] = None
                    ) -> ArrayDataset:
    """The FID reference split (reference ``datasets.py:129-164``): the test
    split of ``cifar*``, ``celeba128`` and ``synthetic*``, the train split
    of ``afhq_*``."""
    if dataset.startswith(("cifar", "synthetic")) or dataset == "celeba128":
        return get_dataset(dataset, data_path)[1]
    if dataset.startswith("afhq_"):
        return get_dataset(dataset, data_path)[0]
    raise NotImplementedError(f"unknown dataset: {dataset}")


__all__ = ["ArrayDataset", "BatchIterator", "DeviceBatchIterator",
           "PrefetchIterator", "ShardedDeviceBatchIterator", "get_dataset",
           "make_train_loader", "get_dataset_ref", "get_image_size",
           "load_image_folder", "synthetic_dataset", "DATA_PATH"]
