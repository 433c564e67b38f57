"""Precompute FID reference statistics to a ``.npz`` file (the port of
``tools/precalc_stats.py``).

Either a registered dataset's reference split or a directory of images ->
``{mu, sigma}``, the file ``test_fid_is``, ``test_tf_inception`` and the
in-loop FID read:

    python -m contrad_tpu_torch.tools.precalc_stats --dataset cifar10 [--out PATH]
    python -m contrad_tpu_torch.tools.precalc_stats --images <dir> --out stats.npz
        [--embed moments]   # the weights-free debug embedder
        [--device cpu]      # the card by default

Without ``--out`` a dataset's statistics (its whole reference split) go
where the in-loop FID looks for them: ``<STATS_DIR>/<dataset>_stats.npz``
for ``inception``, and under ``<STATS_DIR>/<embed>/`` for any other
embedder, so that debug statistics never pass for Inception's
(``evaluate/fid.py::embedder_stats_dir``); an image directory's go beside
it, ``<dir>_stats.npz``. ``--size`` caps the images of ``--images`` and of
``--dataset`` with ``--out``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def read_images(folder: str, size: Optional[int] = None) -> np.ndarray:
    """The PNG/JPG files under ``folder`` (sorted, as the image-folder
    loader lists them; the first ``size`` of them where given) as one
    uint8 (n, H, W, 3) array; every image must have the first one's size."""
    from PIL import Image

    from contrad_tpu_torch.data.folder import _list_images

    files = _list_images(folder)[:size]
    if not files:
        raise FileNotFoundError(f"no images under {folder}")
    first = np.asarray(Image.open(files[0]).convert("RGB"))
    images = np.zeros((len(files),) + first.shape, dtype=np.uint8)
    for i, f in enumerate(files):
        images[i] = np.asarray(Image.open(f).convert("RGB"), dtype=np.uint8)
    return images


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Writes the statistics; returns the file's path."""
    p = argparse.ArgumentParser(description="FID reference statistics")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--dataset", help="registered dataset name (its FID "
                                     "reference split, e.g. cifar10 -> test)")
    g.add_argument("--images", help="directory of PNG/JPG images")
    p.add_argument("--out", default=None, help=".npz output path")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--size", type=int, default=None,
                   help="cap the number of images")
    p.add_argument("--embed", default="inception",
                   choices=["inception", "moments"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from contrad_tpu_torch import resolve_device
    from contrad_tpu_torch.evaluate.fid import (
        compute_stats_from_images, embedder_stats_dir, get_embed_fn,
        precompute_stats)

    embed_fn = get_embed_fn(args.embed, resolve_device(args.device))
    if args.dataset and not args.out:
        path = precompute_stats(args.dataset, embed_fn,
                                embedder_stats_dir(args.embed),
                                args.batch_size)
    else:
        if args.dataset:
            from contrad_tpu_torch.data import get_dataset_ref

            images = np.asarray(
                get_dataset_ref(args.dataset).images[: args.size])
        else:
            images = read_images(args.images, args.size)
            print(f"{len(images)} images from {args.images}")
        mu, sigma = compute_stats_from_images(images, embed_fn,
                                              args.batch_size)
        path = args.out or args.images.rstrip("/") + "_stats.npz"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, mu=mu, sigma=sigma)
    print(f"Wrote {path}")
    return path


if __name__ == "__main__":
    main()
