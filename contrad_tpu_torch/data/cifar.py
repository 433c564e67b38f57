"""CIFAR-10/100 loaders from the standard python pickle batches (copy of
``contrad_tpu/data/cifar.py``; the files must be present under $DATA_DIR)."""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Tuple

import numpy as np

from contrad_tpu_torch.data.core import ArrayDataset


def _maybe_extract(root: str, tar_name: str, dir_name: str) -> str:
    target = os.path.join(root, dir_name)
    if os.path.isdir(target):
        return target
    tar_path = os.path.join(root, tar_name)
    if os.path.isfile(tar_path):
        with tarfile.open(tar_path, "r:gz") as tf:
            tf.extractall(root)
        return target
    raise FileNotFoundError(
        f"CIFAR data not found: expected {target} or {tar_path}. "
        f"Set $DATA_DIR to a directory containing the standard CIFAR archives.")


def _load_batch(path: str, label_key: bytes) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    # (N, 3072) row-major CHW -> NHWC uint8
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[label_key], dtype=np.int64)
    return np.ascontiguousarray(images), labels


def load_cifar10(root: str) -> Tuple[ArrayDataset, ArrayDataset]:
    base = _maybe_extract(root, "cifar-10-python.tar.gz", "cifar-10-batches-py")
    train_parts = [_load_batch(os.path.join(base, f"data_batch_{i}"), b"labels")
                   for i in range(1, 6)]
    train_x = np.concatenate([p[0] for p in train_parts])
    train_y = np.concatenate([p[1] for p in train_parts])
    test_x, test_y = _load_batch(os.path.join(base, "test_batch"), b"labels")
    return (ArrayDataset(train_x, train_y, n_classes=10),
            ArrayDataset(test_x, test_y, n_classes=10))


def load_cifar100(root: str) -> Tuple[ArrayDataset, ArrayDataset]:
    base = _maybe_extract(root, "cifar-100-python.tar.gz", "cifar-100-python")
    train_x, train_y = _load_batch(os.path.join(base, "train"), b"fine_labels")
    test_x, test_y = _load_batch(os.path.join(base, "test"), b"fine_labels")
    return (ArrayDataset(train_x, train_y, n_classes=100),
            ArrayDataset(test_x, test_y, n_classes=100))
