"""krepp_tpu_torch: the PyTorch/CUDA port of krepp_tpu.

The JAX package `krepp_tpu` stays the reference; this package reproduces
its query path with torch ops on an explicit device and hand-written CUDA
kernels for Hopper (sm_90a) in place of the Pallas TPU kernels. It never
imports JAX and nothing of `krepp_tpu`: the host modules it needs (params,
reports, tree, index.colors, io.native, core.native_*, core.hll,
core.stdrand; numpy and ctypes code) are its own copies under the same
names, as is the numpy code of index.build/index/artifact, io.fastx,
inspect and testing. The five C sources (winnower, jplace emitter, radix
sort, colorizer, FASTA/FASTQ reader) are copies in csrc/, built at first
use by the port's own loaders through csrc/build.cc_library.

Conventions:
  * u32 words travel as int32 bit patterns (as the Pallas kernels already
    do); arithmetic that needs unsigned semantics widens to int64.
  * every entry point takes an explicit `device`; "cuda" is the default and
    raises when no card is present. The host runs only when "cpu" is asked
    for explicitly.
"""

import torch

__version__ = "0.1.0"
REFERENCE_VERSION = "v0.8.3"     # of the krepp release whose outputs are matched


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
