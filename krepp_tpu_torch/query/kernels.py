"""Hand-written CUDA kernels of the probe path, with their plain versions.

Each is the port of the Pallas TPU kernel of the same name, with its CUDA
source in krepp_tpu_torch/csrc/<name>.cu; the first three are in
krepp_tpu/query/pallas_kernels.py:
  * `probe_hist_packed` (TPU kernel :210-310): the packed probe epilogue,
    one mask word, S <= 32, X <= 6, P <= 255;
  * `probe_hist_tiles` (:93-207): the general probe epilogue, any P, up to
    8 mask words (S <= 256), embed or 'se' bucket rows;
  * `hdist_chunk` (:28-90): the count-gated Hamming compare of each probe
    with its C candidates;
  * `dma_gather` (tools/probe_microbench.py:157-191): a row gather of a
    narrow u32 table, the bucket-row gather's shape.
A wrapper launches its kernel for CUDA tensors and uses its plain torch
version (`<name>_ref`, the same contract) only for tensors on the host. It
never falls back from a failed build or launch. `<name>.launches` counts
kernel launches (nothing else adds to it). The two epilogue wrappers also
have a measurement hook: with `<name>.keep_next = True` the next launch
leaves copies of its arguments in `<name>.kept` (and resets the flag), so
a benchmark can time the kernel on a batch of the main path. Nothing in
the package sets it.
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
MAX_W = 8                  # mask words of the tiles kernel (S <= 256)
MAX_TILES_SX = 12288       # S * X int32 counters of a warp: 48 KB shared
# elements of the plain tiles version's largest [rows, P, C0, S] temporary
_REF_ELEMS = 1 << 25


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
    if probe_hist_packed.keep_next:
        probe_hist_packed.keep_next = False
        probe_hist_packed.kept = (res.clone(), light.clone(), d.clone(), th,
                                  C0, S)
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
probe_hist_packed.keep_next = False
probe_hist_packed.kept = None


# ------------------------------------------------------------ tiles epilogue
def _check_tiles(res, light, d, mask_tab, th: int, C0: int, W: int, S: int):
    """Validate the tiles contract; returns (N, P, width)."""
    if res.dim() != 2 or light.shape != res.shape or d.dim() != 3 \
            or d.shape[:2] != res.shape:
        raise ValueError(f"shape mismatch: res {tuple(res.shape)}, light "
                         f"{tuple(light.shape)}, d {tuple(d.shape)}")
    if res.dtype != torch.int32 or d.dtype != torch.int32 \
            or light.dtype != torch.bool:
        raise TypeError(f"dtypes must be int32/bool/int32, got {res.dtype}, "
                        f"{light.dtype}, {d.dtype}")
    devs = {res.device, light.device, d.device}
    if mask_tab is not None:
        if mask_tab.dim() != 2 or mask_tab.shape[1] != W \
                or mask_tab.shape[0] < 1 or mask_tab.dtype != torch.int32:
            raise ValueError(f"mask_tab must be int32 [nse >= 1, {W}], got "
                             f"{mask_tab.dtype} {tuple(mask_tab.shape)}")
        devs.add(mask_tab.device)
    if len(devs) != 1:
        raise ValueError("res, light, d and mask_tab must share one device")
    N, P, width = d.shape
    need = 1 + C0 * (1 + W) if mask_tab is None else 1 + 2 * C0
    if not 1 <= C0 <= MAX_C0 or width < need:
        raise ValueError(f"C0={C0}, W={W} do not fit rows of width {width}")
    if not 1 <= W <= MAX_W or (S + 31) // 32 != W or th < 0 or P < 1 \
            or S * (th + 1) > MAX_TILES_SX:
        raise ValueError(f"outside the kernel's contract: W={W} (<= {MAX_W}, "
                         f"= ceil(S/32)), S={S}, X={th + 1} (S*X <= "
                         f"{MAX_TILES_SX}), P={P} (>= 1)")
    return N, P, width


def _tiles_entries(d, mask_tab, C0: int, W: int):
    """Bucket rows [n, P, width] -> (enc [n, P, C0], mask words
    [n, P, C0, W]); 'se' rows (mask_tab given) gather the words by se id,
    clamped into the table as the reference's gather is."""
    n, P, _ = d.shape
    if mask_tab is None:
        ent = d[..., 1: 1 + C0 * (1 + W)].reshape(n, P, C0, 1 + W)
        return ent[..., 0], ent[..., 1:]
    se = torch.clamp(d[..., 1 + C0: 1 + 2 * C0], 0, mask_tab.shape[0] - 1)
    return d[..., 1: 1 + C0], mask_tab[se.to(torch.int64)]


def probe_hist_tiles_ref(res: torch.Tensor, light: torch.Tensor,
                         d: torch.Tensor, mask_tab, th: int, C0: int, W: int,
                         S: int):
    """Plain torch version of the tiles kernel (same signature and outputs).

    res [N, P] int32 probe residuals, light [N, P] bool, d [N, P, width]
    int32 gathered bucket rows: embed rows (mask_tab None; enc_c at column
    1 + c(1+W), its W mask words after it) or 'se' rows (enc_c at 1 + c,
    se id at 1 + C0 + c; mask words from mask_tab [nse, W] int32). A
    candidate matches when hd <= th, light, and any of its mask words is
    non-zero. Per (position, leaf s < S) the minimum matching class counts
    once ("first x wins"). Returns (hist [N, S, th+1] int32, minall [N]
    int32, 255 where nothing matched). Loops over row chunks so no
    temporary exceeds _REF_ELEMS elements."""
    N, P, _ = _check_tiles(res, light, d, mask_tab, th, C0, W, S)
    X = th + 1
    dev = res.device
    hist = torch.zeros((N, S, X), dtype=torch.int32, device=dev)
    minall = torch.empty((N,), dtype=torch.int32, device=dev)
    leaf = torch.arange(S, device=dev)
    word, shift = leaf // 32, (leaf % 32).to(torch.int32)
    rows = max(1, _REF_ELEMS // (P * C0 * S))
    for lo in range(0, N, rows):
        hi = min(N, lo + rows)
        enc, msk = _tiles_entries(d[lo:hi], mask_tab, C0, W)
        hd = hdist_lr32(enc, res[lo:hi, :, None])            # [n, P, C0]
        match = (msk != 0).any(dim=-1) & (hd <= th) & light[lo:hi, :, None]
        minall[lo:hi] = torch.where(match, hd, HD_SENTINEL).amin(dim=(1, 2))
        bits = (msk[..., word] >> shift) & 1                 # [n, P, C0, S]
        mh = torch.where((bits != 0) & match[..., None], hd[..., None],
                         X).amin(dim=2)                      # [n, P, S]
        for x in range(X):
            hist[lo:hi, :, x] = (mh == x).sum(dim=1, dtype=torch.int32)
    return hist, minall


def _tiles_launcher():
    from ..csrc.build import load

    fn = load("probe_hist_tiles").krepp_probe_hist_tiles
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 3)
    return fn


def probe_hist_tiles(res: torch.Tensor, light: torch.Tensor, d: torch.Tensor,
                     mask_tab, th: int, C0: int, W: int, S: int):
    """The general probe epilogue: the CUDA kernel for CUDA tensors, the
    plain version for host tensors. See probe_hist_tiles_ref."""
    if res.device.type == "cpu":
        return probe_hist_tiles_ref(res, light, d, mask_tab, th, C0, W, S)
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    N, P, width = _check_tiles(res, light, d, mask_tab, th, C0, W, S)
    named = [("res", res), ("light", light), ("d", d)]
    if mask_tab is not None:
        named.append(("mask_tab", mask_tab))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    X = th + 1
    hist = torch.empty((N, S, X), dtype=torch.int32, device=res.device)
    minall = torch.empty((N,), dtype=torch.int32, device=res.device)
    if N == 0:
        return hist, minall
    if probe_hist_tiles.keep_next:
        probe_hist_tiles.keep_next = False
        probe_hist_tiles.kept = (res.clone(), light.clone(), d.clone(),
                                 mask_tab, th, C0, W, S)
    fn = _tiles_launcher()
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(res.data_ptr(), light.data_ptr(), d.data_ptr(),
                0 if mask_tab is None else mask_tab.data_ptr(),
                0 if mask_tab is None else mask_tab.shape[0], N, P, width,
                th, C0, W, S, hist.data_ptr(), minall.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"probe_hist_tiles launch failed: cudaError {rc}")
    probe_hist_tiles.launches += 1
    return hist, minall


probe_hist_tiles.launches = 0
probe_hist_tiles.keep_next = False
probe_hist_tiles.kept = None


# ------------------------------------------------------------- hdist chunk
def _check_hdist(res, enc, cnt, th: int):
    """Validate the hdist_chunk contract; returns (N, C)."""
    if res.dim() != 1 or enc.dim() != 2 or enc.shape[0] != res.shape[0] \
            or cnt.shape != res.shape:
        raise ValueError(f"shape mismatch: res {tuple(res.shape)}, enc "
                         f"{tuple(enc.shape)}, cnt {tuple(cnt.shape)}")
    if not res.dtype == enc.dtype == cnt.dtype == torch.int32:
        raise TypeError("res, enc and cnt must be int32")
    if not res.device == enc.device == cnt.device:
        raise ValueError("res, enc and cnt must share one device")
    if enc.shape[1] < 1 or th < 0:
        raise ValueError(f"C={enc.shape[1]} (>= 1), th={th} (>= 0)")
    return enc.shape


def hdist_chunk_ref(res: torch.Tensor, enc: torch.Tensor, cnt: torch.Tensor,
                    th: int = 4):
    """Plain torch version of hdist_chunk: res [N], enc [N, C], cnt [N]
    int32 (u32 bit patterns for res/enc). Returns (hd [N, C] int32, 255
    where j >= cnt or hd > th; gmin [N] int32, the row minimum)."""
    _, C = _check_hdist(res, enc, cnt, th)
    hd = hdist_lr32(enc, res[:, None])
    j = torch.arange(C, dtype=torch.int32, device=res.device)
    hd = torch.where((j[None, :] < cnt[:, None]) & (hd <= th), hd,
                     HD_SENTINEL).to(torch.int32)
    return hd, hd.amin(dim=1)


def _hdist_launcher():
    from ..csrc.build import load

    fn = load("hdist_chunk").krepp_hdist_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 3
    return fn


def hdist_chunk(res: torch.Tensor, enc: torch.Tensor, cnt: torch.Tensor,
                th: int = 4):
    """Count-gated Hamming compare: the CUDA kernel for CUDA tensors, the
    plain version for host tensors. See hdist_chunk_ref."""
    if res.device.type == "cpu":
        return hdist_chunk_ref(res, enc, cnt, th)
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    N, C = _check_hdist(res, enc, cnt, th)
    for name, t in (("res", res), ("enc", enc), ("cnt", cnt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hd = torch.empty((N, C), dtype=torch.int32, device=res.device)
    gmin = torch.empty((N,), dtype=torch.int32, device=res.device)
    if N == 0:
        return hd, gmin
    fn = _hdist_launcher()
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(res.data_ptr(), enc.data_ptr(), cnt.data_ptr(), N, C, th,
                hd.data_ptr(), gmin.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hdist_chunk launch failed: cudaError {rc}")
    hdist_chunk.launches += 1
    return hd, gmin


hdist_chunk.launches = 0


# --------------------------------------------------------------- row gather
def _check_gather(tab, idx, rows_per_block: int):
    """Validate the dma_gather contract; returns (nrows, width, n)."""
    if tab.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"tab must be [nrows, width] and idx [n], got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"tab and idx must be int32, got {tab.dtype}, "
                        f"{idx.dtype}")
    if tab.device != idx.device:
        raise ValueError("tab and idx must share one device")
    if tab.shape[1] < 1 or not 1 <= rows_per_block <= 1024:
        raise ValueError(f"width={tab.shape[1]} (>= 1), rows_per_block="
                         f"{rows_per_block} (1..1024)")
    return tab.shape[0], tab.shape[1], idx.shape[0]


def dma_gather_ref(tab: torch.Tensor, idx: torch.Tensor,
                   rows_per_block: int = 256):
    """Plain torch version of dma_gather: out[i, :] = tab[idx[i], :].

    tab [nrows, width] int32 (u32 bit patterns), idx [n] int32 with
    0 <= idx < nrows. rows_per_block is the kernel's tiling (the TPU
    kernel's TROWS) and does not change the result."""
    _check_gather(tab, idx, rows_per_block)
    return tab[idx.to(torch.int64)]


def _gather_launcher():
    from ..csrc.build import load

    fn = load("dma_gather").krepp_dma_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def dma_gather(tab: torch.Tensor, idx: torch.Tensor,
               rows_per_block: int = 256):
    """Row gather: the CUDA kernel for CUDA tensors, the plain version for
    host tensors. A block of the kernel copies rows_per_block output rows
    (1..1024). See dma_gather_ref."""
    if tab.device.type == "cpu":
        return dma_gather_ref(tab, idx, rows_per_block)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    nrows, width, n = _check_gather(tab, idx, rows_per_block)
    for name, t in (("tab", tab), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((n, width), dtype=torch.int32, device=tab.device)
    if n == 0:
        return out
    fn = _gather_launcher()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(tab.data_ptr(), nrows, width, idx.data_ptr(), n,
                rows_per_block, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dma_gather launch failed: cudaError {rc}")
    dma_gather.launches += 1
    return out


dma_gather.launches = 0
