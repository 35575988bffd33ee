"""Build the port's CUDA kernels with nvcc at first use and load them.

Each `<name>.cu` in this directory exposes a plain `extern "C"` launcher
and compiles on its own into a shared library (no PyTorch headers, so a
build takes seconds), loaded with ctypes. The library lands in `_build/`
beside the sources, named by a hash of the source, the directory's
headers (`*.cuh`) and the flags, so an edited source or header rebuilds
and a stale library is never loaded. nvcc writes to
a temporary name that is renamed into place, so a concurrent loader never
opens a half-written library. nvcc's output (ptxas register and spill
report included) is kept next to it as `<library>.log`. `build` starts one
nvcc per missing library, all at once. `cc_library` builds the port's C
host libraries (winnower, jplace emitter, radix sort, colorizer,
FASTA/FASTQ reader; sources in this directory) into the same directory
the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Sequence

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


def _paths(name: str):
    """(source, library) paths of csrc/<name>.cu."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> List[str]:
    """Paths of the libraries of csrc/<name>.cu; the missing ones are built
    by nvcc processes started together."""
    jobs = []
    outs = []
    for name in names:
        src, out = _paths(name)
        outs.append(out)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, time.time(), proc))
    failed = []
    for src, out, tmp, t0, proc in jobs:
        stdout, stderr = proc.communicate()
        with open(out + ".log", "w") as f:
            f.write(f"# nvcc {' '.join(NVCC_FLAGS)} "
                    f"({time.time() - t0:.2f} s)\n")
            f.write(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def cc_library(src: str, stem: str, flags: Sequence[str],
               build_dir: str = BUILD_DIR, libs: Sequence[str] = ()) -> str:
    """Path of the host library `cc` builds from the C source src into
    build_dir as lib<stem>-<source hash>.so (built if missing, through a
    temporary name renamed into place). A failed build raises."""
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(build_dir, f"lib{stem}-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["cc", *flags, "-o", tmp, src, *libs],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees a stub
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[0])
            _LIBS[name] = lib
        return lib
