"""ImageFolder-style loader with a uint8 ``.npy`` cache (copy of
``contrad_tpu/data/folder.py``; reference ``datasets.py:71-126``).

Images are decoded and resized once into a ``.npy`` memmap next to the
folder, the same file the JAX package writes; afterwards every epoch is
memory reads. PIL is imported only where a folder is decoded.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from contrad_tpu_torch.data.core import ArrayDataset

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _list_images(folder: str):
    out = []
    for dirpath, _, filenames in os.walk(folder):
        for f in sorted(filenames):
            if f.lower().endswith(_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _cache_path(folder: str, image_size: Tuple[int, int, int]) -> str:
    h, w, c = image_size
    return os.path.join(os.path.dirname(folder.rstrip("/")),
                        f".cache_{os.path.basename(folder.rstrip('/'))}_{h}x{w}.npy")


def load_image_folder(folder: str, image_size: Tuple[int, int, int],
                      workers: int = 8) -> ArrayDataset:
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"image folder not found: {folder} (set $DATA_DIR appropriately)")
    h, w, c = image_size
    files = _list_images(folder)
    if not files:
        raise FileNotFoundError(f"no images under {folder}")
    cache = _cache_path(folder, image_size)
    if os.path.exists(cache):
        images = np.load(cache, mmap_mode="r")
        if images.shape == (len(files), h, w, c):
            return ArrayDataset(images)
        # folder contents changed since the cache was built -> rebuild
        del images
        os.remove(cache)

    from PIL import Image  # only here: decoding needs pillow, reading the cache does not

    images = np.lib.format.open_memmap(
        cache, mode="w+", dtype=np.uint8, shape=(len(files), h, w, c))

    def _decode(i_path):
        i, path = i_path
        img = Image.open(path).convert("RGB")
        if img.size != (w, h):
            img = img.resize((w, h), Image.BILINEAR)
        images[i] = np.asarray(img, dtype=np.uint8)

    # one-time build; PIL decode releases the GIL, so threads scale it
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_decode, enumerate(files)))
    images.flush()
    return ArrayDataset(np.load(cache, mmap_mode="r"))
