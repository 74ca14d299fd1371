"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

`load(name)` compiles `csrc/<name>.cu` on first use into a shared library
with a plain C interface, under `stabnet_tpu_torch/_build/` (listed in
.gitignore); `build(names)` compiles several sources at once, one nvcc each,
all started together.  The library name carries a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited kernel is rebuilt
and a stale library is never loaded.  Nothing here runs at import time: this
module imports on machines with no CUDA toolkit, where only the CPU paths
run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> str:
    """`_build/<name>-<hash>.so`; the hash covers the source, the shared
    headers and the flags.  The compiler's output (registers, spills) is
    kept beside it as `.log`."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(SRC_DIR, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> None:
    """Compile every `csrc/<name>.cu` whose library is missing, one nvcc per
    source, all started together; raises RuntimeError with the compiler's
    output if a build fails."""
    procs = []
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        procs.append((name, path, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, proc in procs:
        out = proc.communicate()[0]
        with open(path + ".log", "wb") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n" + out.decode(errors="replace"))
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, compiled first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
