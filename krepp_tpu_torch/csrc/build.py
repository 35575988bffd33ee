"""Build the port's CUDA kernels with nvcc at first use and load them.

Each `<name>.cu` in this directory exposes a plain `extern "C"` launcher
and compiles on its own into a shared library (no PyTorch headers, so a
build takes seconds), loaded with ctypes. The library lands in `_build/`
beside the sources, named by a hash of the source and the flags, so an
edited source rebuilds and a stale library is never loaded. nvcc's output
(ptxas register and spill report included) is kept next to it as
`<library>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(CSRC_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of krepp_tpu_torch are built at first use")
    return found


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu (built if missing)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.time()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(f"# nvcc {' '.join(NVCC_FLAGS)} ({time.time() - t0:.2f} s)\n")
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees a stub
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib
