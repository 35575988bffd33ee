"""DeviceIndex: the frozen LSH table + colors, unified for querying;
PlacementView, the index joined with a placement tree; and DeviceSketch,
a single-target sketch laid out the same way.

JAX-free copy of the numpy layout code of krepp_tpu/index/index.py (that
module imports krepp_tpu.index.build, which imports JAX). The unified CSR
is keyed by

    urow = (rix // m) * R + rank(rix % m)

with R the number of resident residues; sparse row spaces keep a sorted
nonempty-row id table instead of dense offsets. The arrays stay numpy on
the host: the query engine places what it needs on its device.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..params import IndexParams, LSHParams
from ..tree.flat import FlatTree, placement_ancestors, placement_weights
from ..tree.newick import Tree, map_to_qtree
from .build import BuiltIndex, BuiltSketch
from .colors import ColorTable

# Above this many unified rows a dense CSR offset array only pays off when
# the table content is comparably large (dense when >= 1/4 of the rows are
# nonempty, up to DENSE_ROW_CAP); otherwise sorted sparse row ids.
SPARSE_ROW_THRESHOLD = 1 << 24
DENSE_ROW_CAP = 1 << 27

# Per-color leaf bitmasks ([nse, ceil(S/32)] u32) are built only while they
# stay this many words wide (<= 256 leaf slots).
MASK_W_CAP = 8


@dataclass
class DeviceIndex:
    """Host-side arrays of one logical index (fields as krepp_tpu's)."""

    lsh: LSHParams
    resident: np.ndarray      # bool [m]
    res_rank: np.ndarray      # int32 [m], -1 where non-resident
    R: int
    nrows_u: int
    row_start: np.ndarray     # int64 [nrows_u + 1] dense, or [nnz + 1] sparse
    enc_v: np.ndarray         # uint32 [nkmers]
    se_v: np.ndarray          # int32 [nkmers]
    max_bucket: int
    colors: ColorTable
    tree: Optional[Tree]
    ftree: FlatTree
    wbackbone: bool
    names: List[str]
    leaf_ses: np.ndarray      # int32 [S]
    slot_of_se: Dict[int, int]
    rho_slot: np.ndarray      # float64 [S]
    se_mask: Optional[np.ndarray]  # uint32 [nse, W]; None when W > MASK_W_CAP
    info: str = ""
    row_ids: Optional[np.ndarray] = None  # int64 [nnz], sorted; None = dense
    leaf_csr_off: Optional[np.ndarray] = None    # int64 [nse + 1]
    leaf_csr_slots: Optional[np.ndarray] = None  # int32 [total cards]

    @property
    def nkmers(self) -> int:
        return len(self.enc_v)

    @property
    def nleafslots(self) -> int:
        return len(self.leaf_ses)

    @staticmethod
    def from_parts(lsh: LSHParams, residues: Sequence[int],
                   entries: Tuple[np.ndarray, np.ndarray, np.ndarray],
                   colors: ColorTable, tree: Optional[Tree],
                   names: List[str], wbackbone: bool,
                   rho_applied: bool = False, info: str = "") -> "DeviceIndex":
        """Build the unified CSR from (global_row, enc, se) entry arrays.

        Applies the partial-rho coefficient |residues|/m unless rho_applied
        (ref: src/index.cpp:188-201)."""
        m = lsh.m
        g_rows, enc, se = entries
        resident = np.zeros(m, bool)
        for r in residues:
            resident[r] = True
        res_rank = np.full(m, -1, np.int32)
        res_rank[np.flatnonzero(resident)] = np.arange(
            int(resident.sum()), dtype=np.int32)
        R = int(resident.sum())
        nrows_u = ((lsh.nrows_global + m - 1) // m) * R

        urow = (g_rows // m) * R + res_rank[g_rows % m]
        order = _sort_by_row_enc(urow, enc)
        urow = urow[order]
        enc = enc[order]
        se = se[order]
        row_ids, row_start, max_bucket = build_row_csr(urow, nrows_u)

        if not rho_applied:
            # never mutate the caller's ColorTable (coefficients compound)
            colors = dataclasses.replace(colors, rho=colors.rho * (R / m))

        ftree = FlatTree.from_tree(tree) if tree is not None else None
        leaf_ses = ftree.leaf_ses()
        slot_of_se = {int(s): i for i, s in enumerate(leaf_ses)}
        rho_slot = colors.rho[leaf_ses]
        S = len(leaf_ses)
        se_mask = (colors.leaf_masks(slot_of_se, S)
                   if (S + 31) // 32 <= MASK_W_CAP else None)
        slot_map = np.full(colors.nnodes + 2, -1, np.int64)
        slot_map[leaf_ses] = np.arange(S, dtype=np.int64)
        leaf_csr_slots = slot_map[colors.leaf_list].astype(np.int32)
        return DeviceIndex(
            lsh=lsh, resident=resident, res_rank=res_rank, R=R,
            nrows_u=nrows_u, row_start=row_start,
            enc_v=enc.astype(np.uint32), se_v=se.astype(np.int32),
            max_bucket=max_bucket, colors=colors, tree=tree, ftree=ftree,
            wbackbone=wbackbone, names=names, leaf_ses=leaf_ses,
            slot_of_se=slot_of_se, rho_slot=rho_slot, se_mask=se_mask,
            info=info, row_ids=row_ids,
            leaf_csr_off=colors.leaf_off.astype(np.int64),
            leaf_csr_slots=leaf_csr_slots)

    @staticmethod
    def from_built(built: BuiltIndex) -> "DeviceIndex":
        """From a fresh single-partial build (frac or single-residue)."""
        p = built.params
        residues = list(range(p.r + 1)) if p.frac else [p.r]
        if built.inc is None:
            g_rows = _local_row_to_global(built.rows_local, p)
        else:
            g_rows = _local_rows_to_global(built.inc, p)
        return DeviceIndex.from_parts(
            p.lsh, residues, (g_rows, built.enc_v, built.se_v), built.colors,
            built.tree, built.names, wbackbone=built.tree is not None)

    @staticmethod
    def from_reference(di) -> "DeviceIndex":
        """Carry a krepp_tpu DeviceIndex across (its fields are numpy and
        plain Python; nothing is recomputed)."""
        fields = {f.name: getattr(di, f.name)
                  for f in dataclasses.fields(DeviceIndex)}
        out = DeviceIndex(**fields)
        if hasattr(di, "res_info"):
            out.res_info = dict(di.res_info)
        return out

    def placement_view(self, qtree: Optional[Tree] = None) -> "PlacementView":
        return PlacementView.create(self, qtree)


def _sort_by_row_enc(urow: np.ndarray, enc: np.ndarray) -> np.ndarray:
    """argsort by (urow, enc) as one packed-u64 stable argsort."""
    key = (urow.astype(np.uint64) << np.uint64(32)) | enc.astype(np.uint64)
    return np.argsort(key, kind="stable")


def build_row_csr(urow_sorted: np.ndarray, nrows_u: int):
    """CSR offsets over unified rows; sparse row-id table for huge row spaces.

    urow_sorted: per-entry unified row, ascending. Returns
    (row_ids | None, row_start int64, max_bucket)."""
    def dense():
        counts = np.bincount(urow_sorted, minlength=nrows_u)
        row_start = np.zeros(nrows_u + 1, np.int64)
        np.cumsum(counts, out=row_start[1:])
        return None, row_start, int(counts.max()) if len(counts) else 0

    if nrows_u <= SPARSE_ROW_THRESHOLD:
        return dense()
    if len(urow_sorted):
        change = np.empty(len(urow_sorted), bool)
        change[0] = True
        np.not_equal(urow_sorted[1:], urow_sorted[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        row_ids = urow_sorted[starts]
        counts = np.diff(np.append(starts, len(urow_sorted)))
    else:
        row_ids = np.asarray(urow_sorted[:0])
        counts = np.empty(0, np.int64)
    if nrows_u <= DENSE_ROW_CAP and nrows_u <= 4 * len(row_ids):
        return dense()
    row_start = np.zeros(len(row_ids) + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    return (row_ids.astype(np.int64), row_start,
            int(counts.max()) if len(counts) else 0)


def _local_rows_to_global(inc: np.ndarray, p: IndexParams) -> np.ndarray:
    """Reference-scheme CSR end-offsets -> per-entry global rows; inverts
    local = (rix//m)*(r+1) + rix%m (frac) / rix//m (ref: src/rqseq.cpp:125-139)."""
    nrows = len(inc)
    starts = np.concatenate([[0], inc[:-1]])
    counts = (inc - starts).astype(np.int64)
    local = np.repeat(np.arange(nrows, dtype=np.int32), counts)
    if p.frac:
        q, res = np.divmod(local, np.int32(p.r + 1))
        return q * np.int32(p.m) + res
    return local * np.int32(p.m) + np.int32(p.r)


def _local_row_to_global(local: np.ndarray, p: IndexParams) -> np.ndarray:
    """Per-entry local row -> global LSH row (the sparse-inc build path)."""
    local = local.astype(np.int64)
    if p.frac:
        q, res = np.divmod(local, p.r + 1)
        return q * p.lsh.m + res
    return local * p.lsh.m + p.r


@dataclass
class PlacementView:
    """Index joined with a placement (query) tree.

    Captures map_to_qtree + eff_nchildren (ref: src/phytree.cpp:421-473) as
    arrays: leaf_qse[slot] = qtree node id (0 if the leaf is absent from the
    placement tree), each slot's ancestor chain with its damping weights
    (anc_q, anc_w: the non-zeros of the dense matrix W, see
    tree.flat.placement_ancestors) and, built on first use only, W itself
    (`weights`, [qn+1, S] f64: the dense stage-3 formulation's)."""

    index: DeviceIndex
    qtree: Tree
    qflat: FlatTree
    leaf_qse: np.ndarray      # int32 [S]
    anc_q: np.ndarray         # int64 [S, D]
    anc_w: np.ndarray         # float64 [S, D]
    candidate_ok: np.ndarray  # bool [qn+1]: structural candidate filter

    @functools.cached_property
    def weights(self) -> np.ndarray:
        return placement_weights(self.qflat, self.leaf_qse)

    @staticmethod
    def create(index: DeviceIndex, qtree: Optional[Tree]) -> "PlacementView":
        if qtree is None or qtree is index.tree:
            qtree = index.tree
            qflat = index.ftree
            leaf_qse = index.leaf_ses.copy()
        else:
            se_to_node = map_to_qtree(index.tree, qtree)
            qflat = FlatTree.from_tree(qtree)
            leaf_qse = np.zeros(len(index.leaf_ses), np.int32)
            for i, se in enumerate(index.leaf_ses):
                nd = se_to_node[int(se)]
                leaf_qse[i] = nd.se if nd is not None else 0
        anc_q, anc_w = placement_ancestors(qflat, leaf_qse)
        # (ref: src/query.cpp:268-281): keep nodes whose children are all
        # covered and that are not unary
        cand = (qflat.nchildren == qflat.eff_nchildren) & (qflat.nchildren != 1)
        cand[0] = False
        return PlacementView(index=index, qtree=qtree, qflat=qflat,
                             leaf_qse=leaf_qse, anc_q=anc_q, anc_w=anc_w,
                             candidate_ok=cand)


@dataclass
class DeviceSketch:
    """Single-target sketch arrays (ref: src/sketch.{hpp,cpp}); fields as
    krepp_tpu's."""

    lsh: LSHParams
    w: int
    r: int
    frac: bool
    resident: np.ndarray
    res_rank: np.ndarray
    R: int
    nrows_u: int
    row_start: np.ndarray
    enc_v: np.ndarray
    max_bucket: int
    rho: float
    row_ids: Optional[np.ndarray] = None

    @property
    def nkmers(self) -> int:
        return len(self.enc_v)

    @staticmethod
    def from_built(built: BuiltSketch) -> "DeviceSketch":
        p = built.params
        lsh = p.lsh
        m = lsh.m
        resident = np.zeros(m, bool)
        resident[list(range(p.r + 1)) if p.frac else [p.r]] = True
        res_rank = np.full(m, -1, np.int32)
        R = int(resident.sum())
        res_rank[np.flatnonzero(resident)] = np.arange(R, dtype=np.int32)
        nrows_u = ((lsh.nrows_global + m - 1) // m) * R
        g_rows = _local_rows_to_global(built.inc, p)
        urow = (g_rows // m) * R + res_rank[g_rows % m]
        order = _sort_by_row_enc(urow, built.enc_v)
        row_ids, row_start, max_bucket = build_row_csr(urow[order], nrows_u)
        # rho partial rescale (ref: src/sketch.cpp:25-32)
        return DeviceSketch(lsh=lsh, w=p.w, r=p.r, frac=p.frac,
                            resident=resident, res_rank=res_rank, R=R,
                            nrows_u=nrows_u, row_start=row_start,
                            enc_v=built.enc_v[order].astype(np.uint32),
                            max_bucket=max_bucket, rho=built.rho * (R / m),
                            row_ids=row_ids)

    @staticmethod
    def from_reference(sk) -> "DeviceSketch":
        """Carry a krepp_tpu DeviceSketch across (numpy and plain Python
        fields; nothing is recomputed)."""
        return DeviceSketch(**{f.name: getattr(sk, f.name)
                               for f in dataclasses.fields(DeviceSketch)})
