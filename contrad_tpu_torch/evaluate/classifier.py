"""Classifier evaluation (the port of ``contrad_tpu/evaluate/classifier.py``;
reference ``evaluate/classifier.py``, ``evaluate/__init__.py``).

Evaluators wrap a ``logits_fn(images) -> logits`` (and optionally a
projection function and an augmentation) instead of switching module modes.
Metric keys and semantics are the reference ``test_classifier``'s (loss,
error@1, adv@1, noisy@1, nt_xent0.1). Logits and labels may be tensors on
any device or numpy arrays; the metrics are computed on the host in
float64, as in the JAX package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from contrad_tpu_torch.augment import AugRng
from contrad_tpu_torch.training.losses import nt_xent


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _float_images(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


class AverageMeter:
    """Running average (reference evaluate/__init__.py:20-38)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.value = 0.0
        self.average = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        value = float(value)
        self.value = value
        self.sum += value * n
        self.count += n
        self.average = self.sum / self.count


class BaseEvaluator(ABC):
    def update(self, *args):
        pass

    @abstractmethod
    def summary(self):
        ...

    @abstractmethod
    def reset(self):
        ...


def accuracy(outputs, targets, topk: Sequence[int] = (1,)):
    """Top-k accuracies in percent."""
    outputs, targets = _np(outputs), _np(targets)
    maxk = max(topk)
    pred = np.argsort(-outputs, axis=1)[:, :maxk]  # (N, maxk)
    correct = pred == targets[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def error_k(outputs, targets, ks: Sequence[int] = (1,)):
    return [100.0 - a for a in accuracy(outputs, targets, topk=ks)]


def cross_entropy(logits, targets) -> float:
    logits = _np(logits).astype(np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(targets)), _np(targets)].mean())


class XEntLoss(BaseEvaluator):
    def __init__(self, logits_fn):
        self._acc = AverageMeter()
        self._logits_fn = logits_fn

    def update(self, inputs, labels):
        logits = self._logits_fn(inputs)
        self._acc.update(cross_entropy(logits, labels), len(labels))
        return self._acc.value

    def summary(self):
        return self._acc.average

    def reset(self):
        self._acc.reset()


class TopkErrorRate(BaseEvaluator):
    def __init__(self, logits_fn, k: int = 1):
        self._acc = AverageMeter()
        self._logits_fn = logits_fn
        self.k = k

    def update(self, inputs, labels):
        logits = self._logits_fn(inputs)
        (err,) = error_k(logits, labels, ks=(self.k,))
        self._acc.update(err, len(labels))
        return self._acc.value

    def summary(self):
        return self._acc.average

    def reset(self):
        self._acc.reset()


class NoisyTopkErrorRate(TopkErrorRate):
    """Error rate under an input corruption (reference classifier.py:104-113)."""

    def __init__(self, logits_fn, noise: Optional[Callable] = None, k: int = 1):
        super().__init__(logits_fn, k)
        self.noise = noise or (lambda x: x)

    def update(self, inputs, labels):
        return super().update(self.noise(inputs), labels)


class AdversarialTopkErrorRate(TopkErrorRate):
    """Error rate under a label-aware adversary (reference classifier.py:116-125)."""

    def __init__(self, logits_fn, adversary: Optional[Callable] = None,
                 k: int = 1):
        super().__init__(logits_fn, k)
        self.adversary = adversary or (lambda x, y: x)

    def update(self, inputs, labels):
        return super().update(self.adversary(inputs, labels), labels)


class NT_XEntLoss(BaseEvaluator):
    """NT-Xent of two augmented projection views (reference
    classifier.py:128-161); temperature 0.1, normalized. ``augment`` has
    ``sample(shape, rng)`` and ``apply(x, params)``."""

    def __init__(self, projection_fn, augment=None, seed: int = 0):
        self._acc = AverageMeter()
        self._projection_fn = projection_fn
        self.augment = augment
        self.seed = seed
        self._rng = None

    def update(self, inputs, labels):
        x = _float_images(inputs)
        if self._rng is None:
            self._rng = AugRng.from_seed(self.seed, x.device)
        views = []
        for _ in range(2):
            xv = x
            if self.augment is not None:
                xv = self.augment.apply(x, self.augment.sample(x.shape,
                                                               self._rng))
            views.append(self._projection_fn(xv))
        loss = nt_xent(*views, temperature=0.1, normalize=True)
        self._acc.update(float(loss), 2 * len(labels))
        return self._acc.value

    def summary(self):
        return self._acc.average

    def reset(self):
        self._acc.reset()


def fgsm_adversary(grad_fn, eps: float = 8.0 / 255.0):
    """Single-step FGSM on [0,1] images; grad_fn(x, y) -> dL/dx."""

    def adversary(inputs, labels):
        x = _float_images(inputs)
        g = grad_fn(x, torch.as_tensor(labels, device=x.device))
        return torch.clamp(x + eps * torch.sign(g), 0.0, 1.0)

    return adversary


def test_classifier(logits_fn, data_iter: Iterable, metrics: Sequence[str],
                    augment=None, adversary: Optional[Callable] = None,
                    projection_fn: Optional[Callable] = None
                    ) -> Dict[str, float]:
    """Run the requested metric evaluators over (images, labels) batches
    (reference classifier.py:164-182)."""
    noise = None
    if augment is not None:
        rngs = {}

        def noise(x):
            x = _float_images(x)
            rng = rngs.setdefault("rng", AugRng.from_seed(1, x.device))
            return augment.apply(x, augment.sample(x.shape, rng))

    evaluators: Dict[str, BaseEvaluator] = {
        "loss": XEntLoss(logits_fn),
        "error@1": TopkErrorRate(logits_fn),
        "adv@1": AdversarialTopkErrorRate(logits_fn, adversary),
        "noisy@1": NoisyTopkErrorRate(logits_fn, noise),
    }
    if projection_fn is not None:
        evaluators["nt_xent0.1"] = NT_XEntLoss(projection_fn, augment)

    for images, labels in data_iter:
        for key in metrics:
            evaluators[key].update(images, labels)

    return {k: evaluators[k].summary() for k in metrics}


test_classifier.__test__ = False  # a library function, not a pytest test
