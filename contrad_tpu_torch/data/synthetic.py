"""Procedural synthetic dataset (copy of ``contrad_tpu/data/synthetic.py``):
the same numpy draws, so a seed gives the same images in both packages."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from contrad_tpu_torch.data.core import ArrayDataset


def synthetic_dataset(image_size: Tuple[int, int, int], n: int = 2048,
                      seed: int = 0, n_classes: int = 10,
                      class_signal: bool = False) -> ArrayDataset:
    """Structured blobs + noise: enough signal for losses to move.
    ``class_signal=True`` anchors each blob's position to its label."""
    h, w, c = image_size
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=(n,))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.empty((n, h, w, c), dtype=np.uint8)
    for i in range(n):
        if class_signal:
            ang = 2 * np.pi * labels[i] / n_classes
            jit = rng.uniform(-0.06, 0.06, 2)
            cy = (0.5 + 0.25 * np.sin(ang) + jit[0]) * h
            cx = (0.5 + 0.25 * np.cos(ang) + jit[1]) * w
        else:
            cy, cx = rng.uniform(0.25, 0.75, 2) * (h, w)
        sigma = rng.uniform(0.1, 0.3) * h
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)))
        base = rng.uniform(0.1, 0.4, size=(1, 1, c)).astype(np.float32)
        img = base + blob[..., None] * rng.uniform(0.3, 0.6, size=(1, 1, c))
        img += rng.normal(0, 0.03, size=(h, w, c))
        images[i] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return ArrayDataset(images, labels, n_classes=n_classes)
