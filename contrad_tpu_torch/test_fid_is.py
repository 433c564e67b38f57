"""FID and Inception Score over a directory of images, the port's CLI (the
counterpart of the repo root's ``test_fid_is.py``):

    python -m contrad_tpu_torch.test_fid_is <sample_dir> \\
        (--stats <ref.npz> | --dataset <name>) [--embed inception]

scores the PNGs under ``sample_dir`` against reference statistics: a
``.npz`` of ``mu`` and ``sigma`` (``--stats``), or a dataset's, computed and
cached on first use (``--dataset``; ``third_party/fid/`` for
``inception``, its ``<embedder>/`` subdirectory for the others). Appends
``n_images, fid, is_mean, is_std`` to ``<sample_dir>/fid_is.csv`` (or
``--out``). IS needs the Inception weights whatever ``--embed`` is;
``--no_is`` skips it. Images are read with the port's PNG reader (the
card's machine has no pillow). It runs on the card; ``--device cpu`` runs
it on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="FID/IS over an image directory")
    p.add_argument("sample_dir", type=str, help="directory of sampled PNGs")
    p.add_argument("--stats", type=str, default=None,
                   help="reference statistics .npz (mu, sigma)")
    p.add_argument("--dataset", type=str, default=None,
                   help="dataset whose reference statistics to use")
    p.add_argument("--size", type=int, default=None,
                   help="score at most this many images (default: all)")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--no_is", action="store_true", help="skip the IS")
    p.add_argument("--out", type=str, default=None, help="CSV output path")
    p.add_argument("--embed", default="inception",
                   choices=["inception", "torch_inception", "moments"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_images(directory: str, limit: Optional[int] = None) -> np.ndarray:
    """The PNGs under ``directory`` (sorted paths, at most ``limit``) as one
    (n, H, W, 3) uint8 array."""
    from contrad_tpu_torch.data.folder import _list_images
    from contrad_tpu_torch.evaluate.visual import read_png

    files = _list_images(directory)[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {directory}")
    return np.stack([read_png(f) for f in files])


def reference_stats(P, embed_fn):
    from contrad_tpu_torch.evaluate.fid import (
        embedder_stats_dir, precompute_stats, stats_path)

    if P.stats:
        path = P.stats
    elif P.dataset:
        stats_dir = embedder_stats_dir(P.embed)
        path = stats_path(P.dataset, stats_dir)
        if not os.path.exists(path):
            path = precompute_stats(P.dataset, embed_fn, stats_dir,
                                    P.batch_size)
    else:
        raise ValueError("provide --stats or --dataset for the FID reference")
    stats = np.load(path)
    return stats["mu"], stats["sigma"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Score the directory; returns ``n_images``, ``fid``, ``is_mean``,
    ``is_std`` and the CSV's path."""
    from contrad_tpu_torch import resolve_device
    from contrad_tpu_torch.evaluate.fid import (
        calculate_frechet_distance, compute_stats_from_images, get_embed_fn)
    from contrad_tpu_torch.evaluate.inception_score import inception_score
    from contrad_tpu_torch.utils.logger import append_csv

    P = parse_args(argv)
    device = resolve_device(P.device)
    images = load_images(P.sample_dir, P.size)
    print(f"Scoring {len(images)} images from {P.sample_dir}")
    embed_fn = get_embed_fn(P.embed, device)
    ref_mu, ref_sigma = reference_stats(P, embed_fn)
    mu, sigma = compute_stats_from_images(images, embed_fn, P.batch_size)
    fid = float(calculate_frechet_distance(mu, sigma, ref_mu, ref_sigma))
    print(f"FID: {fid:.4f}")

    is_mean = is_std = float("nan")
    if not P.no_is:
        is_mean, is_std = inception_score(images, splits=P.splits,
                                          batch_size=P.batch_size,
                                          device=device)
        print(f"IS: {is_mean:.4f} +- {is_std:.4f}")

    out = P.out or os.path.join(P.sample_dir, "fid_is.csv")
    append_csv(out, ["n_images", "fid", "is_mean", "is_std"],
               [len(images), fid, is_mean, is_std])
    print(f"Wrote {out}")
    return dict(n_images=len(images), fid=fid, is_mean=is_mean,
                is_std=is_std, csv=out)


if __name__ == "__main__":
    main()
