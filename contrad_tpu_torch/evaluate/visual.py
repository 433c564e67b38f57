"""Images out of a run (the port of ``contrad_tpu/evaluate/visual.py``'s
``to_uint8`` and ``make_grid``), and a PNG writer on the standard library's
``zlib`` and ``struct``: 8-bit RGB (or grey), one IDAT chunk, filter 0 on
every row. The JAX CLIs write PNGs with imageio; the card's machine has
neither imageio nor pillow."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def to_uint8(images) -> np.ndarray:
    """float [0,1] NHWC (a tensor on any device, or an array) -> uint8."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    x = np.asarray(images)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Tile NHWC uint8 images into one HWC image."""
    n, h, w, c = images.shape
    ncol = nrow
    nr = (n + ncol - 1) // ncol
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0: y0 + h, x0: x0 + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """An HWC (C = 3: RGB, C = 1: grey) or HW uint8 image as PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError("encode_png takes uint8 images")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    color = {1: 0, 3: 2}[c]  # PNG colour types: greyscale, truecolour
    rows = np.concatenate([np.zeros((h, 1), np.uint8),  # filter 0 per row
                           image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
