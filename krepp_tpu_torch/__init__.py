"""krepp_tpu_torch: the PyTorch/CUDA port of krepp_tpu.

The JAX package `krepp_tpu` stays the reference; this package reproduces
its query path with torch ops on an explicit device and hand-written CUDA
kernels for Hopper (sm_90a) in place of the Pallas TPU kernels. It never
imports JAX: the framework-free host modules of `krepp_tpu` (params,
reports, tree, index.colors, io.native, core.native_*, core.hll,
core.stdrand, core.sdust) are reused, and the numpy code of the modules
that would pull JAX in (index.build/index/artifact, io.fastx, inspect,
testing) is carried here as JAX-free copies. The C winnower and jplace
emitter are built by the port's own loaders (core/native_extract.py,
io/native_report.py).

Conventions:
  * u32 words travel as int32 bit patterns (as the Pallas kernels already
    do); arithmetic that needs unsigned semantics widens to int64.
  * every entry point takes an explicit `device`; "cuda" is the default and
    raises when no card is present. The host runs only when "cpu" is asked
    for explicitly.
"""

import torch

from krepp_tpu import REFERENCE_VERSION  # noqa: F401  (JAX-free package root)

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """Device name or torch.device -> torch.device, validated.

    "cuda" without a visible card raises instead of falling back to the
    host. On the card, TF32 is switched off for matmuls and convolutions:
    stage 2 is f64 throughout and no contraction may silently drop to TF32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false; pass --device cpu to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
