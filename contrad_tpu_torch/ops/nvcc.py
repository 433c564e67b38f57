"""The build of the port's CUDA sources (``csrc/*.cu``): ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``contrad_tpu_torch/_build/`` once per source hash (a temporary file renamed
into place, so that processes building at once never load half a library),
loaded with ``ctypes``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def build(source: Path, symbols: Dict[str, Tuple[Sequence[Any], Any]],
          verbose: bool = False) -> ctypes.CDLL:
    """Compile ``source`` (once per source hash) and load it, each function
    of ``symbols`` given its ``(argtypes, restype)``. ``verbose`` prints what
    ``-Xptxas -v`` says of each kernel (registers, shared memory, spills)."""
    data = source.read_bytes()
    target = BUILD_DIR / (f"lib{source.stem}_"
                          f"{hashlib.sha1(data).hexdigest()[:12]}.so")
    if not target.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}:\n"
                               f"{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, (argtypes, restype) in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), restype
    return lib
