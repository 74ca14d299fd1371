"""The native post-processing library (g++ -> shared library -> ctypes).

`load()` compiles `native/crop.cc` on first use into
`stabnet_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing runs at import time.  Unlike the JAX package, the port
has no Python fallback here: a failed build or load raises, and the Python
search (`ops.crop.max_clear_rect_plain`) serves only as the tests' yardstick.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from stabnet_tpu_torch.ops.cuda_build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "crop.cc")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """`_build/crop-<hash>.so`; the hash covers the source and the flags."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"crop-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path.  Raises
    RuntimeError with the compiler's output if g++ is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ not found: the native crop is built from "
                           f"{SRC} at first use ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """The loaded library, compiled first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.max_clear_rect.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.max_clear_rect.restype = None
        _lib = lib
    return _lib


def max_clear_rect(black: np.ndarray) -> Tuple[int, int, int, int]:
    """(top, left, bottom, right) of the largest all-clear rectangle of an
    (H, W) count map (> 0 is black); raises ValueError if every pixel is
    black."""
    lib = load()
    arr = np.ascontiguousarray(np.asarray(black), dtype=np.int64)
    if arr.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got shape {arr.shape}")
    H, W = arr.shape
    out = np.zeros(5, np.int64)
    lib.max_clear_rect(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), H, W,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if out[4] == 0:
        raise ValueError("no black-free pixel; cannot crop")
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])
