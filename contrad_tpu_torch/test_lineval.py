"""Linear evaluation CLI of the port (the counterpart of the repo root's
``test_lineval.py``): load a trained D from a run's logdir, freeze it, and
train a linear probe on its eval-mode penultimate features.

    python -m contrad_tpu_torch.test_lineval <logdir> sndcgan [--epochs 100]

As the JAX CLI: SGD at lr 0.1 (no momentum) for ``--epochs`` epochs,
divided by 10 at epochs 60, 75 and 90; the SupContrast linear-eval
augmentation, RRC(0.2, 1) + horizontal flip (reference
``datasets.py:23-47``), on the device; the probe dataset derived from the
run's (``cifar10`` -> ``cifar10_lin``, ``cifar100`` -> ``cifar100_lin``,
``synthetic*`` -> itself) unless ``--dataset`` names one; a CSV
``<logdir>/lin_eval_<tag>.csv`` with the reference's columns and the probe
saved as ``lin_eval_<tag>.npz`` (``w``: (features, classes), ``b``). The
epoch's losses and accuracies stay on the device until it ends. It runs on
the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CSV_HEADER = "epoch,time,lr,train loss,train acc,test loss,test acc\n"
MILESTONES = (60, 75, 90)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Linear evaluation of D features")
    p.add_argument("logdir", type=str, help="Run logdir with the D checkpoint")
    p.add_argument("architecture", type=str)
    p.add_argument("--n_classes", default=10, type=int)
    p.add_argument("--dataset", default=None, type=str,
                   help="the probe dataset (default: derived from the run "
                        "config's options.dataset)")
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--ckpt", default="latest", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def probe_dataset(base: str) -> str:
    """The probe's dataset for a run trained on ``base``
    (reference ``test_lineval.py:134``)."""
    if base.startswith("cifar10") and not base.startswith("cifar100"):
        return "cifar10_lin"
    if base.startswith("cifar100"):
        return "cifar100_lin"
    if base.startswith("synthetic"):
        return base
    raise NotImplementedError(f"linear eval undefined for {base}")


def lin_augment():
    """RRC(0.2, 1) + horizontal flip."""
    from contrad_tpu_torch.augment import (
        Compose, HorizontalFlip, RandomResizeCrop)

    return Compose(RandomResizeCrop(scale=(0.2, 1.0)), HorizontalFlip())


def lr_at(epoch: int) -> float:
    lr = 0.1
    for m in MILESTONES:
        if epoch >= m:
            lr *= 0.1
    return lr


def features(D, x: torch.Tensor) -> torch.Tensor:
    """Frozen eval-mode penultimate features (reference
    test_lineval.py:79-82) of float images in [0, 1]."""
    with torch.no_grad():
        _, aux = D(x, train=False, persist=False)
    return aux["penultimate"]


def probe_step(D, probe: Dict[str, torch.Tensor], images: torch.Tensor,
               labels: torch.Tensor, aug, aug_params, lr: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step of the probe ``{"w", "b"}`` (in place) on augmented
    ``images`` (uint8 or float NHWC); returns the mean cross-entropy and
    the logits, before the update."""
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images
    feats = features(D, aug.apply(x, aug_params))
    w = probe["w"].detach().requires_grad_(True)
    b = probe["b"].detach().requires_grad_(True)
    logits = feats @ w + b
    loss = F.cross_entropy(logits, labels)
    gw, gb = torch.autograd.grad(loss, (w, b))
    with torch.no_grad():
        probe["w"] -= lr * gw
        probe["b"] -= lr * gb
    return loss.detach(), logits.detach()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train and test the probe; returns the CSV's and the probe's paths
    and one record per epoch (seconds, lr, train and test loss and
    accuracy in percent)."""
    from contrad_tpu_torch.augment import AugRng
    from contrad_tpu_torch.data import DeviceBatchIterator, get_dataset
    from contrad_tpu_torch.evaluate.classifier import test_classifier
    from contrad_tpu_torch.utils.run_loading import load_run

    P = parse_args(argv)
    cfg, _, D, _, _ = load_run(P.logdir, P.architecture, ckpt=P.ckpt,
                               device=P.device)
    device = next(D.parameters()).device
    dataset = P.dataset or probe_dataset(cfg.options.dataset)
    train_set, test_set, _ = get_dataset(dataset)
    loader = DeviceBatchIterator(train_set, P.batch_size, seed=P.seed,
                                 device=device, with_labels=True)
    test_images = torch.from_numpy(np.ascontiguousarray(test_set.images)).to(
        device)
    test_labels = np.asarray(test_set.labels)
    aug, rng = lin_augment(), AugRng.from_seed(P.seed, device)
    probe = {"w": torch.zeros(D.d_penul, P.n_classes, device=device),
             "b": torch.zeros(P.n_classes, device=device)}

    last = {}

    def logits_fn(x):
        # the evaluators ask for the same batch's logits once per metric
        if last.get("x") is not x:
            last.update(x=x, logits=features(D, x.float() / 255.0)
                        @ probe["w"] + probe["b"])
        return last["logits"]

    tag = np.random.randint(10000)
    csv_path = os.path.join(P.logdir, f"lin_eval_{tag}.csv")
    with open(csv_path, "w") as f:
        f.write(CSV_HEADER)
    steps_per_epoch = len(train_set) // P.batch_size
    epochs = []
    for epoch in range(P.epochs):
        t0 = time.perf_counter()
        lr = lr_at(epoch)
        tr_loss = torch.zeros((), device=device)
        tr_correct = torch.zeros((), device=device)
        for _ in range(steps_per_epoch):
            images, labels = next(loader)
            params = aug.sample(images.shape, rng)
            loss, logits = probe_step(D, probe, images, labels, aug, params,
                                      lr)
            tr_loss += loss * len(labels)
            tr_correct += (logits.argmax(dim=1) == labels).sum()
        test_iter = ((test_images[i: i + P.batch_size],
                      test_labels[i: i + P.batch_size])
                     for i in range(0, len(test_set), P.batch_size))
        out = test_classifier(logits_fn, test_iter, ["loss", "error@1"])
        n_seen = steps_per_epoch * P.batch_size
        rec = dict(epoch=epoch, seconds=time.perf_counter() - t0, lr=lr,
                   train_loss=float(tr_loss) / n_seen,
                   train_acc=100.0 * float(tr_correct) / n_seen,
                   test_loss=out["loss"], test_acc=100 - out["error@1"])
        with open(csv_path, "a") as f:
            f.write(f"{epoch},{rec['seconds']:.8},{lr:.4},"
                    f"{rec['train_loss']:.4},{rec['train_acc']:.4},"
                    f"{rec['test_loss']:.4},{rec['test_acc']:.4}\n")
        print(f"Epoch {epoch}: * [Loss {out['loss']:.3f}] "
              f"[Err@1 {out['error@1']:.3f}]")
        epochs.append(rec)

    npz_path = os.path.join(P.logdir, f"lin_eval_{tag}.npz")
    np.savez(npz_path, w=probe["w"].cpu().numpy(), b=probe["b"].cpu().numpy())
    print(f"Saved probe to lin_eval_{tag}.npz; log: {csv_path}")
    return dict(csv=csv_path, npz=npz_path, epochs=epochs)


if __name__ == "__main__":
    main()
