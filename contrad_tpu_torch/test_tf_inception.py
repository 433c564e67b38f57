"""The reference's ``test_tf_inception.py`` command line, the port's CLI
(the counterpart of the repo root's ``test_tf_inception.py``): FID and IS of
a directory of images against a statistics ``.npz``.

    python -m contrad_tpu_torch.test_tf_inception <images> <stats.npz> \\
        [--n_imgs 10000] [--embed inception]

Appends ``<dir name>, <fid>`` to ``fid.log`` and ``<dir name>, <is mean>,
<is std>`` to ``inception.log`` beside the image directory, as the
reference does (``test_tf_inception.py:31-41, 99-115``). ``--embed
torch_inception`` is the InceptionV3 with ``third_party/torch_fid``'s
resize (no antialiasing); ``--embed moments`` is the weights-free debug
embedder, which has no classifier, so the IS is skipped. ``--gpu`` is
accepted for the reference's command line; ``--inception_dir`` names a
directory holding the ``.pth``. It runs on the card; ``--device cpu`` runs
it on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="FID / IS of an image directory")
    p.add_argument("images", type=str, help="directory of generated images")
    p.add_argument("stats", type=str, help="precomputed .npz statistics")
    p.add_argument("--n_imgs", type=int, default=10000,
                   help="number of images scored")
    p.add_argument("--batch_size", type=int, default=500)
    p.add_argument("--gpu", type=str, default="",
                   help="accepted for the reference's command line")
    p.add_argument("--inception_dir", type=str, default=None,
                   help="directory holding pt_inception-2015-12-05-*.pth")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--embed", default="inception",
                   choices=["inception", "torch_inception", "moments"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Score the directory; returns ``fid``, ``is_mean`` and ``is_std``."""
    from contrad_tpu_torch import resolve_device
    from contrad_tpu_torch.evaluate.fid import (
        calculate_frechet_distance, compute_stats_from_images, get_embed_fn)
    from contrad_tpu_torch.evaluate.inception import get_inception_logits_fn
    from contrad_tpu_torch.evaluate.inception_score import inception_score
    from contrad_tpu_torch.test_fid_is import load_images

    P = parse_args(argv)
    device = resolve_device(P.device)
    if P.inception_dir:
        for f in sorted(os.listdir(P.inception_dir)):
            if f.endswith(".pth"):
                os.environ["INCEPTION_WEIGHTS"] = os.path.join(
                    P.inception_dir, f)
                break
    images = load_images(P.images, P.n_imgs)
    if P.verbose:
        print(f"# DEBUG:::PATH_DATA = {P.images} ({len(images)} images)")

    ref = np.load(P.stats)
    embed_fn = get_embed_fn(P.embed, device)
    mu, sigma = compute_stats_from_images(images, embed_fn, P.batch_size)
    fid = float(calculate_frechet_distance(mu, sigma, ref["mu"], ref["sigma"]))
    if P.embed == "moments":
        print("IS skipped (--embed moments has no classifier)")
        is_mean = is_std = float("nan")
    else:
        probs_fn = get_inception_logits_fn(
            device=device, antialias=P.embed == "inception")
        is_mean, is_std = inception_score(images, probs_fn=probs_fn,
                                          batch_size=P.batch_size)

    logdir = os.path.dirname(os.path.abspath(P.images.rstrip("/")))
    name = os.path.basename(P.images.rstrip("/"))
    with open(os.path.join(logdir, "fid.log"), "a") as f:
        f.write(f"{name}, {fid}\n")
    with open(os.path.join(logdir, "inception.log"), "a") as f:
        f.write(f"{name}, {is_mean}, {is_std}\n")
    print(f"FID: {fid}")
    print(f"IS: {is_mean} +- {is_std}")
    return dict(fid=fid, is_mean=is_mean, is_std=is_std)


if __name__ == "__main__":
    main()
