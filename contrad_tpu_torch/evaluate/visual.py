"""Images out of a run (the port of ``contrad_tpu/evaluate/visual.py``;
reference ``evaluate/gan.py:15-82``): ``to_uint8``, ``make_grid``, the
fixed-latent grids of the training-progress GIF
(:class:`FixedSampleGeneration`) and the augmented-real preview
(:class:`ImageGrid`).

The JAX CLIs write images with imageio; the card's machine has neither
imageio nor pillow, so the port encodes them on the standard library:
  * PNG (``zlib``, ``struct``): 8-bit RGB or grey, one IDAT chunk, filter 0
    on every row; :func:`read_png` decodes 8-bit grey, grey + alpha, RGB and
    RGBA PNGs with any of the five row filters, not interlaced;
  * GIF89a: a fixed 256-entry palette (3 bits of red, 3 of green, 2 of
    blue, each pixel taken to the nearest level), variable-width LZW coded
    in Python, and a NETSCAPE block that loops the animation. Each frame is
    encoded once.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, List, Optional

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


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (types 0-4) on the decompressed rows."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sums along the row, per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left one
            cur, b = line.tolist(), prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b[i]) >> 1)) & 0xFF
                    continue
                c = b[i - bpp] if i >= bpp else 0
                p = a + b[i] - c
                pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc
                                                        else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file as an (H, W, 3) uint8 RGB image: grey is repeated over the
    three channels and alpha dropped, as ``PIL.Image.convert('RGB')`` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, RGB and "
                         f"their alpha forms are read (bit depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    image = pixels.reshape(h, w, channels)
    image = image[..., :1] if channels < 3 else image[..., :3]
    return np.repeat(image, 3, axis=2) if image.shape[2] == 1 else image


# ------------------------------------------------------------------ GIF

# the fixed palette: index r * 32 + g * 4 + b for r, g in 0..7, b in 0..3
_LEVELS = (np.arange(8) * 255 / 7 + 0.5).astype(np.uint8), \
    (np.arange(4) * 255 / 3 + 0.5).astype(np.uint8)
PALETTE = np.stack(np.meshgrid(_LEVELS[0], _LEVELS[0], _LEVELS[1],
                               indexing="ij"), axis=-1).reshape(256, 3)


def quantize(image: np.ndarray) -> np.ndarray:
    """HWC uint8 RGB (or grey) -> HW palette indices, each channel to its
    nearest level."""
    if image.shape[2] == 1:
        image = np.repeat(image, 3, axis=2)
    x = image.astype(np.int32)
    r, g, b = ((x[..., 0] * 7 + 127) // 255, (x[..., 1] * 7 + 127) // 255,
               (x[..., 2] * 3 + 127) // 255)
    return (r * 32 + g * 4 + b).astype(np.uint8)


def lzw_encode(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of ``indices`` (codes of ``min_size``
    bits): a clear code first, codes widening from ``min_size + 1`` bits up
    to 12, the table cleared when it is full, an end code last; the bits
    packed least significant first."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    buf = nbits = 0
    size, next_code, table = min_size + 1, end + 1, {}

    buf |= clear << nbits
    nbits += size
    it = iter(indices)
    w = next(it, None)
    if w is None:
        raise ValueError("an empty image")
    for k in it:
        key = (w << 8) | k
        code = table.get(key)
        if code is not None:
            w = code
            continue
        buf |= w << nbits
        nbits += size
        while nbits >= 8:
            out.append(buf & 0xFF)
            buf >>= 8
            nbits -= 8
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:  # the table is full: start afresh
            buf |= clear << nbits
            nbits += size
            size, next_code, table = min_size + 1, end + 1, {}
        w = k
    buf |= w << nbits
    nbits += size
    if next_code == (1 << size) and size < 12:
        size += 1  # the decoder adds an entry for ``w`` before the end code
    buf |= end << nbits
    nbits += size
    while nbits > 0:
        out.append(buf & 0xFF)
        buf >>= 8
        nbits -= 8
    return bytes(out)


def gif_frame(image: np.ndarray, delay_cs: int = 10) -> bytes:
    """One frame of an HWC uint8 image: its graphic control block (a delay
    of ``delay_cs`` hundredths of a second), image descriptor and LZW data
    in sub-blocks of 255 bytes."""
    h, w = image.shape[:2]
    data = lzw_encode(quantize(image).tobytes())
    blocks = b"".join(bytes([len(data[i: i + 255])]) + data[i: i + 255]
                      for i in range(0, len(data), 255))
    return (b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
            + b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00"
            + b"\x08" + blocks + b"\x00")


def encode_gif(frames: List[bytes], width: int, height: int) -> bytes:
    """A looping GIF89a of encoded frames (:func:`gif_frame`) of
    ``width`` x ``height``, on the fixed palette."""
    return (b"GIF89a" + struct.pack("<HHBBB", width, height, 0xF7, 0, 0)
            + PALETTE.tobytes()
            + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
            + b"".join(frames) + b"\x3b")


# ------------------------------------------------------- training progress

class FixedSampleGeneration:
    """A 4x4 grid of G's images from ``n`` fixed latents at each evaluation,
    the frames of the training-progress GIF (reference
    ``evaluate/gan.py:48-82``). The latents are drawn once, on G's device,
    from a ``torch.Generator`` seeded ``seed`` (the CLIs pass their
    ``--seed`` + 1); ``volatile`` keeps nothing."""

    def __init__(self, generator, seed: int, n: int = 16,
                 volatile: bool = False):
        self.volatile = volatile
        self.n = n
        self.device = next(generator.parameters()).device
        self.z = None
        if not volatile:
            rng = torch.Generator(device=self.device).manual_seed(seed)
            self.z = generator.sample_latent(n, rng)
        self.frames: List[np.ndarray] = []
        self._gif_frames: List[bytes] = []  # each frame encoded once

    def update(self, sample_from_z: Callable[[torch.Tensor], torch.Tensor]
               ) -> Optional[np.ndarray]:
        """Append the grid of ``sample_from_z(z)`` and return it."""
        if self.volatile:
            return None
        frame = make_grid(to_uint8(sample_from_z(self.z)), nrow=4)
        self.frames.append(frame)
        return frame

    def summary(self) -> List[np.ndarray]:
        return self.frames

    def write_gif(self, path: str) -> None:
        """The frames so far as a looping GIF at ``path``."""
        for frame in self.frames[len(self._gif_frames):]:
            self._gif_frames.append(gif_frame(frame))
        h, w = self.frames[0].shape[:2]
        with open(path, "wb") as f:
            f.write(encode_gif(self._gif_frames, w, h))

    # Resume: the SAME latents (and the frames so far) across a restart
    # keep the GIF one trajectory (the reference redraws the latents on
    # --resume, evaluate/gan.py:48-58).
    def state_dict(self) -> dict:
        if self.volatile:
            return {}
        return {"z": self.z.detach().float().cpu().numpy(),
                "frames": (np.stack(self.frames) if self.frames
                           else np.zeros((0,), dtype=np.uint8))}

    def load_state_dict(self, state: dict) -> None:
        if self.volatile or "z" not in state:
            return
        self.z = torch.from_numpy(np.asarray(state["z"])).to(
            self.device, self.z.dtype)
        frames = np.asarray(state["frames"])
        self.frames = [] if frames.size == 0 else list(frames)
        self._gif_frames = []


class ImageGrid:
    """An 8-wide grid of the first ``n`` images (reference
    ``evaluate/gan.py:15-45``): the CLIs' augmented-real preview."""

    def __init__(self, n: int = 64, volatile: bool = False):
        self.n = n
        self.volatile = volatile

    def update(self, images) -> Optional[np.ndarray]:
        if self.volatile:
            return None
        return make_grid(to_uint8(images[: self.n]), nrow=8)
