"""FID: Frechet Inception Distance (the port of
``contrad_tpu/evaluate/fid.py``; reference ``third_party/fid/fid_score.py``,
``evaluate/gan.py:85-159``).

The protocol is the JAX package's:
  * a dataset's reference statistics are computed once on its reference
    split (:func:`~contrad_tpu_torch.data.get_dataset_ref`) and cached as
    ``third_party/fid/<dataset>_stats.npz`` for the ``inception`` embedder,
    ``third_party/fid/<embedder>/<dataset>_stats.npz`` for any other: the
    files the JAX package writes, so a file either package wrote serves the
    other (``$FID_STATS_DIR`` in place of ``third_party/fid`` where set);
  * an update draws ``size`` samples, embeds them and averages ``n_avg``
    FID trials; chunk ``i`` of trial ``seed`` is drawn from seed
    ``seed * 100003 + i``;
  * the square root of the covariance product is scipy's ``sqrtm``, retried
    with an ``eps`` ridge where it is not finite, its imaginary part
    dropped where it is negligible.

The in-loop evaluation drives :meth:`FIDScore.update` with ``feature_fn``,
the sampler and embedder on the card (``evaluate/sharded.py``); only the
features come to the host, where the O(d^3) statistics run in numpy and
scipy in float64.

    python -m contrad_tpu_torch.evaluate.fid <dataset> --embed moments

computes and caches a dataset's reference statistics.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import numpy as np
from scipy import linalg

from contrad_tpu_torch.utils.logger import append_csv

# Sampler: (n, seed) -> float images (n, H, W, C) in [0, 1]
SamplerFn = Callable[[int, int], np.ndarray]
# Embedder: uint8 or float images (n, H, W, C) -> features (n, d)
EmbedFn = Callable[[np.ndarray], np.ndarray]

# The statistics cache: ``third_party/fid/`` of the checkout, where the JAX
# package keeps it, or ``$FID_STATS_DIR``.
STATS_DIR = os.environ.get("FID_STATS_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "third_party", "fid")
EMBEDDERS = ("inception", "torch_inception", "moments")


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """|mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2)), with the reference's
    numerical guards (``fid_score.py:58-112``)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if isinstance(covmean, tuple):  # older scipy returns (sqrtm, errest)
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"sqrtm has large imaginary component: "
                f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2.0 * np.trace(covmean))


def compute_stats(features: np.ndarray):
    """Mean and covariance of ``(n, d)`` features, in float64."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def compute_stats_from_sampler(sampler: SamplerFn, embed_fn: EmbedFn,
                               size: int, batch_size: int = 50, seed: int = 0):
    """``size`` samples in batches of ``batch_size``, batch ``i`` drawn
    from seed ``seed * 100003 + i`` (reference ``fid_score.py:115-158``)."""
    feats = []
    remaining, i = size, 0
    while remaining > 0:
        n = min(batch_size, remaining)
        feats.append(np.asarray(embed_fn(sampler(n, seed * 100003 + i))))
        remaining -= n
        i += 1
    return compute_stats(np.concatenate(feats, axis=0)[:size])


def compute_stats_from_images(images: np.ndarray, embed_fn: EmbedFn,
                              batch_size: int = 50):
    feats = [np.asarray(embed_fn(images[i: i + batch_size]))
             for i in range(0, len(images), batch_size)]
    return compute_stats(np.concatenate(feats, axis=0))


def stats_path(dataset: str, stats_dir: Optional[str] = None) -> str:
    return os.path.join(stats_dir or STATS_DIR, f"{dataset}_stats.npz")


def embedder_stats_dir(embedder: str, stats_dir: Optional[str] = None) -> str:
    """Where ``embedder``'s reference statistics live: ``stats_dir`` where
    given, else ``STATS_DIR``, and its ``<embedder>/`` subdirectory for
    every embedder but ``inception``, so that the statistics of a debug
    embedder never pass for Inception's."""
    if stats_dir is not None:
        return stats_dir
    return STATS_DIR if embedder == "inception" else os.path.join(STATS_DIR,
                                                                  embedder)


def precompute_stats(dataset: str, embed_fn: EmbedFn,
                     stats_dir: Optional[str] = None,
                     batch_size: int = 50) -> str:
    """Compute and cache the reference statistics of ``dataset``'s
    reference split; returns the file's path. The file is written under a
    temporary name and moved into place."""
    from contrad_tpu_torch.data import get_dataset_ref

    path = stats_path(dataset, stats_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mu, sigma = compute_stats_from_images(get_dataset_ref(dataset).images,
                                          embed_fn, batch_size)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, mu=mu, sigma=sigma)
    os.replace(tmp, path)
    return path


def fid_score(sampler: SamplerFn, embed_fn: EmbedFn, ref_mu, ref_sigma,
              size: int, batch_size: int = 50, seed: int = 0) -> float:
    mu, sigma = compute_stats_from_sampler(sampler, embed_fn, size,
                                           batch_size, seed)
    return float(calculate_frechet_distance(mu, sigma, ref_mu, ref_sigma))


def moments_embed_fn(images: np.ndarray) -> np.ndarray:
    """Weights-free debug embedder: per-channel mean and standard deviation
    and the means of a coarse 4x4 grid, in float64.

    NOT a real FID metric: it lets the whole in-loop FID (statistics cache,
    ``n_avg`` trials, best tracking, CSV, the ``ckpt/best`` gate) run where
    the Inception weights are missing (``--fid_embed moments``). Its scores
    compare only with each other."""
    x = np.asarray(images, dtype=np.float64)
    if images.dtype == np.uint8:
        x = x / 255.0
    h = x.shape[1]
    q = max(h // 4, 1)
    feats = [x.mean(axis=(1, 2)), x.std(axis=(1, 2))]
    for i in range(0, h - q + 1, q):
        for j in range(0, x.shape[2] - q + 1, q):
            cell = x[:, i: i + q, j: j + q]
            feats.append(cell.mean(axis=(1, 2, 3))[:, None])
    return np.concatenate([f.reshape(len(x), -1) for f in feats], axis=1)


def get_embed_fn(name: str = "inception", device="cuda") -> EmbedFn:
    """A host embedder by name: ``inception`` (the port's InceptionV3 on
    ``device``, needs the weights file), ``torch_inception`` (the same
    network with ``third_party/torch_fid``'s resize, which does not
    antialias) or ``moments`` (numpy, no weights)."""
    if name in ("inception", "torch_inception"):
        from contrad_tpu_torch.evaluate.inception import get_inception_embed_fn

        return get_inception_embed_fn(device=device,
                                      antialias=name == "inception")
    if name == "moments":
        return moments_embed_fn
    raise ValueError(f"unknown fid embedder: {name}")


class FIDScore:
    """In-loop FID tracker (reference ``evaluate/gan.py:85-159``): reference
    statistics computed on first use and cached, ``n_avg`` trials per
    update, the best score so far, one CSV row per update with the trials'
    scores. ``device`` is where the Inception embedders run when the
    statistics must be computed."""

    def __init__(self, dataset: str, size: int = 10000, n_avg: int = 3,
                 embed_fn: Optional[EmbedFn] = None,
                 stats_dir: Optional[str] = None, batch_size: int = 50,
                 embedder: str = "inception", precompute_ok: bool = True,
                 device="cuda"):
        stats_dir = embedder_stats_dir(embedder, stats_dir)
        self.dataset = dataset
        self.size = size
        self.n_avg = n_avg
        self._embed_fn = embed_fn  # resolved on first use: see embed_fn
        self.embedder = embedder
        self.batch_size = batch_size
        self.device = device

        path = stats_path(dataset, stats_dir)
        if not os.path.exists(path):
            if not precompute_ok:
                raise FileNotFoundError(
                    f"FID reference stats missing at {path}; compute them "
                    f"once first: python -m contrad_tpu_torch.evaluate.fid "
                    f"{dataset} --embed {embedder}")
            path = precompute_stats(dataset, self.embed_fn, stats_dir,
                                    batch_size)
        stats = np.load(path)
        self.ref_mu, self.ref_sigma = stats["mu"], stats["sigma"]

        self.history: list = []  # rows: [step, trial_0..trial_{n-1}, mean]
        self.best = float("inf")
        self.is_best = False
        self.last_diversity = self.last_meanshift = float("nan")

    @property
    def embed_fn(self) -> EmbedFn:
        """The host embedder, loaded on first use: the train CLIs drive
        :meth:`update` with ``feature_fn``, so where the statistics are
        cached the Inception weights are loaded once, by the sampler."""
        if self._embed_fn is None:
            self._embed_fn = get_embed_fn(self.embedder, self.device)
        return self._embed_fn

    def update(self, step: int, sampler: Optional[SamplerFn] = None,
               feature_fn: Optional[Callable] = None) -> float:
        """One evaluation: ``n_avg`` FID trials. Pass EITHER ``sampler``
        (images to the host, embedded in batches of ``batch_size``: the
        reference protocol) or ``feature_fn`` (``(n, seed) -> (n, d)``
        features, the sampler and embedder on the card)."""
        if (sampler is None) == (feature_fn is None):
            raise ValueError("pass exactly one of sampler / feature_fn")
        scores, diversity, meanshift = [], [], []
        for trial in range(self.n_avg):
            if feature_fn is not None:
                mu, sigma = compute_stats(
                    np.asarray(feature_fn(self.size, trial)))
            else:
                mu, sigma = compute_stats_from_sampler(
                    sampler, self.embed_fn, self.size, self.batch_size,
                    seed=trial)
            scores.append(float(calculate_frechet_distance(
                mu, sigma, self.ref_mu, self.ref_sigma)))
            # FID's two additive parts, which any embedder gives: the
            # features' spread against the reference's (mode collapse shows
            # as << 1) and the distance of their means
            diversity.append(
                float(np.trace(np.atleast_2d(sigma))
                      / max(np.trace(np.atleast_2d(self.ref_sigma)), 1e-12)))
            meanshift.append(float(np.linalg.norm(mu - self.ref_mu)))
        avg = float(np.mean(scores))
        self.last_diversity = float(np.mean(diversity))
        self.last_meanshift = float(np.mean(meanshift))
        self.history.append([step] + scores + [avg])
        self.is_best = avg < self.best
        if self.is_best:
            self.best = avg
        return avg

    def save(self, path: str) -> None:
        """Append the last update's row to the CSV at ``path``."""
        header = ["step"] + [f"fid_{i}" for i in range(self.n_avg)] + ["mean"]
        if self.history:
            append_csv(path, header, self.history[-1])

    # Resume: the reference loses the history and the best on --resume
    # (evaluate/gan.py:147-159), so a post-restart evaluation could
    # overwrite ckpt/best with a worse score; the sidecar keeps them.
    def state_dict(self) -> dict:
        hist = (np.asarray(self.history, dtype=np.float64)
                if self.history else np.zeros((0, self.n_avg + 2)))
        return {"history": hist, "best": np.float64(self.best),
                "embedder": np.str_(self.embedder),
                "size": np.int64(self.size)}

    def load_state_dict(self, state: dict) -> None:
        """A ``best`` holds only under the embedder and size that produced
        it: another embedder or size starts the tracker afresh. Another
        ``n_avg`` keeps ``best`` and drops the history, whose rows would be
        ragged against new ones. A state without the provenance keys is
        taken as it is."""
        emb = str(state.get("embedder", self.embedder))
        size = int(state.get("size", self.size))
        if emb != self.embedder or size != self.size:
            self.history, self.best, self.is_best = [], float("inf"), False
            return
        hist = np.asarray(state["history"], dtype=np.float64)
        if hist.ndim == 2 and hist.shape[1] == self.n_avg + 2:
            self.history = [list(map(float, row)) for row in hist]
        else:
            self.history = []
        self.best = float(state["best"])
        self.is_best = False


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Compute and cache a dataset's reference statistics; returns the
    file's path."""
    p = argparse.ArgumentParser(description="FID reference statistics")
    p.add_argument("dataset", type=str)
    p.add_argument("--embed", default="inception", choices=EMBEDDERS)
    p.add_argument("--batch_size", default=50, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    P = p.parse_args(argv)
    from contrad_tpu_torch import resolve_device

    device = resolve_device(P.device)
    path = precompute_stats(P.dataset, get_embed_fn(P.embed, device),
                            embedder_stats_dir(P.embed), P.batch_size)
    print(f"Wrote {path}")
    return path


if __name__ == "__main__":
    main()
