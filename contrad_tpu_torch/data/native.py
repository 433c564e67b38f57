"""The native batch gather of the host-fed data path (the port of
``contrad_tpu/data/native/``): ``csrc/batch_gather.cpp``, a multithreaded
row gather and a SplitMix64 shuffle behind a plain C interface, compiled
with ``g++`` at first use into ``contrad_tpu_torch/_build/`` (once per
source hash) and loaded with ctypes.

Unlike the JAX package, which quietly falls back to numpy where it cannot
compile or load the library, a build or load failure raises here: no path
changes behind the caller's back. Below :data:`NATIVE_MIN_BYTES` a batch is
gathered with ``np.take``, as in JAX: starting the threads costs about a
millisecond, more than a single memcpy loop takes for such a batch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "batch_gather.cpp"
_BUILD_DIR = _PKG / "_build"
NATIVE_MIN_BYTES = 24 * 1024 * 1024  # JAX's rule (native/__init__.py:75-78)

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/batch_gather.cpp`` (once per source hash) and load
    it; raises where ``g++`` fails or the library does not load."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        source = _SOURCE.read_bytes()
        target = _BUILD_DIR / (f"libbatch_gather_"
                               f"{hashlib.sha1(source).hexdigest()[:12]}.so")
        if not target.exists():
            _BUILD_DIR.mkdir(exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            res = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-pthread", str(_SOURCE),
                 "-o", str(tmp)], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({res.returncode}) on {_SOURCE}:\n"
                    f"{res.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        lib.gather_batch_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        lib.gather_batch_u8.restype = None
        lib.shuffled_indices.argtypes = [
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p]
        lib.shuffled_indices.restype = None
        _library = lib
        return lib


def gather_native(src: np.ndarray, indices: np.ndarray, out: np.ndarray,
                  n_threads: int = 0) -> np.ndarray:
    """``out[i] = src[indices[i]]`` through the library at any size (uint8
    rows, ``out`` C-contiguous); ``n_threads`` 0 picks one thread per 8 MB,
    at least 2 and at most the CPU count."""
    if src.dtype != np.uint8 or out.dtype != np.uint8:
        raise TypeError("the native gather takes uint8 arrays")
    shape = (len(indices),) + src.shape[1:]
    if not out.flags.c_contiguous or out.shape != shape:
        raise ValueError(f"out must be C-contiguous of shape {shape}")
    lib = build()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    item_bytes = int(np.prod(src.shape[1:]))
    if n_threads <= 0:
        n_threads = max(2, min(os.cpu_count() or 1,
                               item_bytes * len(indices) // (8 << 20)))
    src_flat = np.ascontiguousarray(src).reshape(src.shape[0], -1)
    lib.gather_batch_u8(src_flat.ctypes.data_as(ctypes.c_void_p),
                        indices.ctypes.data_as(ctypes.c_void_p),
                        len(indices), item_bytes,
                        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out


def gather_batch(src: np.ndarray, indices: np.ndarray,
                 out: Optional[np.ndarray] = None,
                 n_threads: int = 0) -> np.ndarray:
    """``out[i] = src[indices[i]]`` for uint8 rows: multithreaded in C++
    from :data:`NATIVE_MIN_BYTES` up, ``np.take`` below. ``out`` (a new
    array where None) may be a view of a pinned host buffer."""
    if src.dtype != np.uint8:
        raise TypeError("the batch gather takes uint8 images")
    build()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if out is None:
        out = np.empty((len(indices),) + src.shape[1:], dtype=np.uint8)
    if int(np.prod(src.shape[1:])) * len(indices) < NATIVE_MIN_BYTES:
        np.take(np.asarray(src), indices, axis=0, out=out)
        return out
    return gather_native(src, indices, out, n_threads)


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` (int64): Fisher-Yates driven by
    SplitMix64 from ``seed``, the JAX package's."""
    out = np.empty(n, dtype=np.int64)
    build().shuffled_indices(n, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
                             out.ctypes.data_as(ctypes.c_void_p))
    return out
