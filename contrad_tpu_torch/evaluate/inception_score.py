"""Inception Score (the port of ``contrad_tpu/evaluate/inception_score.py``;
reference ``third_party/inception_score.py``): exp of the mean over splits
of E_x[KL(p(y|x) || p(y))], 10 splits by default."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

ProbsFn = Callable[[np.ndarray], np.ndarray]


def inception_score_from_probs(probs: np.ndarray,
                               splits: int = 10) -> Tuple[float, float]:
    """(mean, std) over ``splits`` of the class probabilities ``probs``."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        py = np.mean(part, axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(images: np.ndarray, probs_fn: Optional[ProbsFn] = None,
                    splits: int = 10, batch_size: int = 50,
                    device="cuda") -> Tuple[float, float]:
    """IS of NHWC uint8 or float ``images``: (mean, std) over splits.
    ``probs_fn`` defaults to the port's InceptionV3 on ``device``."""
    if probs_fn is None:
        from contrad_tpu_torch.evaluate import inception

        probs_fn = inception.get_inception_logits_fn(device=device)
    probs = np.concatenate([probs_fn(images[i: i + batch_size])
                            for i in range(0, len(images), batch_size)])
    return inception_score_from_probs(probs, splits)
