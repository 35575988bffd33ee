"""Hand-written CUDA kernels of the probe path, with their plain versions.

`probe_hist_packed` is the port of the Pallas TPU kernel of the same name
(krepp_tpu/query/pallas_kernels.py:210-310); its CUDA source is
krepp_tpu_torch/csrc/probe_hist_packed.cu. The wrapper launches the kernel
for CUDA tensors and uses `probe_hist_packed_ref`, the plain torch version
of the same contract, only for tensors on the host. It never falls back
from a failed build or launch. `probe_hist_packed.launches` counts kernel
launches (nothing else adds to it).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.codec import hdist_lr32

HD_SENTINEL = 255          # "no match" Hamming distance marker
MAX_X = 6
MAX_P = 255
MAX_S = 32
MAX_C0 = 2


def _check(res, light, d, th: int, C0: int, S: int):
    """Validate the contract; returns (N, P, width)."""
    if res.dim() != 2 or light.shape != res.shape or d.dim() != 3 \
            or d.shape[:2] != res.shape:
        raise ValueError(f"shape mismatch: res {tuple(res.shape)}, light "
                         f"{tuple(light.shape)}, d {tuple(d.shape)}")
    if res.dtype != torch.int32 or d.dtype != torch.int32 \
            or light.dtype != torch.bool:
        raise TypeError(f"dtypes must be int32/bool/int32, got {res.dtype}, "
                        f"{light.dtype}, {d.dtype}")
    if not (res.device == light.device == d.device):
        raise ValueError("res, light and d must share one device")
    N, P, width = d.shape
    if not 1 <= C0 <= MAX_C0 or width < 1 + 2 * C0:
        raise ValueError(f"C0={C0} does not fit rows of width {width}")
    if th + 1 > MAX_X or th < 0 or P > MAX_P or P < 1 or not 1 <= S <= MAX_S:
        raise ValueError(f"outside the kernel's gate: X={th + 1} (<= {MAX_X}), "
                         f"P={P} (<= {MAX_P}), S={S} (<= {MAX_S})")
    return N, P, width


def probe_hist_packed_ref(res: torch.Tensor, light: torch.Tensor,
                          d: torch.Tensor, th: int, C0: int, S: int):
    """Plain torch version of the kernel (same signature and outputs).

    res [N, P] int32, light [N, P] bool, d [N, P, width] int32 gathered
    bucket rows (enc_c at column 1 + 2c, mask_c at 2 + 2c). Returns
    (hist [N, S, th+1] int32, minall [N] int32, 255 where nothing matched).
    """
    N, P, _ = _check(res, light, d, th, C0, S)
    X = th + 1
    shifts = torch.arange(S, dtype=torch.int32, device=res.device)
    mh = torch.full((N, P, S), X, dtype=torch.int32, device=res.device)
    for c in range(C0):
        hd = hdist_lr32(d[..., 1 + 2 * c], res)
        hdg = torch.where((hd <= th) & light, hd, X)
        bit = (d[..., 2 + 2 * c, None] >> shifts) & 1
        mh = torch.minimum(mh, torch.where(bit != 0, hdg[..., None], X))
    hist = torch.stack([(mh == x).sum(dim=1, dtype=torch.int32)
                        for x in range(X)], dim=-1)
    gm = mh.amin(dim=(1, 2))
    return hist, torch.where(gm >= X, HD_SENTINEL, gm).to(torch.int32)


def _launcher():
    from ..csrc.build import load

    lib = load("probe_hist_packed")
    fn = lib.krepp_probe_hist_packed
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    return fn


def probe_hist_packed(res: torch.Tensor, light: torch.Tensor,
                      d: torch.Tensor, th: int, C0: int, S: int):
    """The packed probe epilogue: the CUDA kernel for CUDA tensors, the
    plain version for host tensors. See probe_hist_packed_ref."""
    if res.device.type == "cpu":
        return probe_hist_packed_ref(res, light, d, th, C0, S)
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    N, P, width = _check(res, light, d, th, C0, S)
    for name, t in (("res", res), ("light", light), ("d", d)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    X = th + 1
    hist = torch.empty((N, S, X), dtype=torch.int32, device=res.device)
    minall = torch.empty((N,), dtype=torch.int32, device=res.device)
    if N == 0:
        return hist, minall
    fn = _launcher()
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(res.data_ptr(), light.data_ptr(), d.data_ptr(), N, P, width,
                th, C0, S, hist.data_ptr(), minall.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"probe_hist_packed launch failed: cudaError {rc}")
    probe_hist_packed.launches += 1
    return hist, minall


probe_hist_packed.launches = 0
