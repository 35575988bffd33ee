"""Query engine for `dist` and `place`: batched LSH probe + histogram + ML
distance (place runs its stage-3 steps on it through `run_step`).

Port of the hybrid and CSR modes of krepp_tpu/query/engine.py (see its
module docstring for the pipeline and the reference citations). Stage 1
runs the strand hashes, the bucket-row gather and a probe epilogue kernel
on the card (`probe_hist_packed` for one mask word, S <= 32, hdist_th <= 5
and <= 255 positions; `probe_hist_tiles` for everything else), then the
compacted heavy tail; stage 2 runs lane-compacted filtering, Brent and
strand resolution in native f64. Capacities, tiers and overflow flags are
the reference's, so the same batches escalate.

Covered: every index with a leaf bitmask table (S <= 256 leaves, W <= 8
mask words), 'embed' and 'se' bucket rows, any read length and any
hdist_th; CSR mode when no bucket-row table fits DIRECT_MEM_CAP; and
event mode for indexes without bitmasks (more than 256 leaves): 'se'
bucket rows probed through query/event_probe.py and joined into stage-2
lanes with no [B, S] array, which runs no epilogue kernel. The sharded
engines (parallel/mesh.py) reuse the probe bodies per shard.

Host syncs per step (a step does not run fully asynchronously): the heavy
tail's deepest-bucket count (when buckets exceed the heavy table; in CSR
mode the deepest bucket of each strand and of its top-k tail; in event
mode the ultra-deep E-slot loop's bound), the Brent lane count, and
Brent's convergence check every few iterations.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import codec, trace
from ..core.compact import compact_mask_indices, compact_mask_indices_strided
from ..core.host_turn import host_int, host_wait
from ..core.llh import F, brent_llh, make_llh, make_llh_np
from ..index.index import DeviceIndex, DeviceSketch
from .bucket_scan import (_scan_loop, make_expander, probe_strand,
                          probe_strand_full, scan_buckets_min)
from .event_probe import event_probe_lanes, heavy_id
from .kernels import (HD_SENTINEL, MAX_P, MAX_S, MAX_X, probe_hist_packed,
                      probe_hist_tiles)

D_MAX = np.finfo(np.float64).max  # Minfo d_llh default (ref: src/query.hpp:226)

# Capacity constants: the reference's values, so tiers match it.
DENSE_SLOTS = 2
HEAVY_DIV = 32
HEAVY_SAFETY = 1.5
EXACT_MIX = 0.35
TAIL_UNROLL = 16
DEEP_DIV = 256
DIRECT_MEM_CAP = 2 << 30
EMBED_W_CAP = 2
HEAVY_TAB_CAP = 512 << 20
# SeekEngine's direct table is full-width (no heavy tail behind it), so it
# only pays off for shallow sketches; deeper ones scan the CSR.
SEEK_DIRECT_CAP = 16
# elements of the heavy tail's largest [lanes, S, X] one-hot temporary
ONEHOT_ELEMS = 1 << 25
# Test hook: event mode on an index that has bitmasks (the reference's
# KREPP_EVENT_PROBE=1); tests monkeypatch it.
FORCE_EVENT = False


def hybrid_flavor(nrows: int, max_bucket: int, W: int) -> Optional[str]:
    """Pick the hybrid bucket-row flavor that fits DIRECT_MEM_CAP (None if
    none)."""
    C0 = min(DENSE_SLOTS, max(1, max_bucket))
    if W <= EMBED_W_CAP and nrows * (1 + C0 * (1 + W)) * 4 <= DIRECT_MEM_CAP:
        return "embed"
    if nrows * (1 + 2 * C0) * 4 <= DIRECT_MEM_CAP:
        return "se"
    return None


def build_hybrid_slots(row_start: np.ndarray, enc_v: np.ndarray,
                       se_v: np.ndarray, se_mask: Optional[np.ndarray],
                       nrows_dense, max_bucket: int, W: int,
                       flavor: Optional[str] = None):
    """The hybrid bucket-row table over one CSR (numpy, as the reference).

    nrows_dense: the dense row count, or None for a sparse table (nonempty
    rows + one trailing zero row). flavor forces a layout ('se' in event
    mode, which has no se_mask). Returns (slots u32 [nrows, width],
    flavor) or (None, None) when the layout does not fit DIRECT_MEM_CAP."""
    C0 = min(DENSE_SLOTS, max(1, max_bucket))
    ncontent = len(row_start) - 1
    nrows = ncontent if nrows_dense is not None else ncontent + 1
    if flavor is None:
        flavor = hybrid_flavor(nrows, max_bucket, W)
    elif nrows * (1 + 2 * C0) * 4 > DIRECT_MEM_CAP:
        flavor = None
    if flavor is None:
        return None, None
    width = 1 + C0 * (1 + W) if flavor == "embed" else 1 + 2 * C0
    counts = np.diff(row_start)
    slots = np.zeros((nrows, width), np.uint32)
    slots[:ncontent, 0] = counts.astype(np.uint32)
    row_of = np.repeat(np.arange(ncontent, dtype=np.int64), counts)
    j = (np.arange(len(enc_v), dtype=np.int64)
         - np.repeat(row_start[:-1], counts))
    first = j < C0
    rows_d = row_of[first]
    jd = j[first]
    if flavor == "embed":
        col = (1 + jd * (1 + W)).astype(np.int64)
        slots[rows_d, col] = enc_v[first]
        mask_rows = se_mask[se_v[first]]
        for wd in range(W):
            slots[rows_d, col + 1 + wd] = mask_rows[:, wd]
    else:
        slots[rows_d, 1 + jd] = enc_v[first]
        slots[rows_d, 1 + C0 + jd] = se_v[first].astype(np.uint32)
    return slots, flavor


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """numpy u32/i32 array -> int32 bit-pattern tensor on device."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array (u32 as int32 bit patterns) -> tensor on device; to the
    card through pinned memory, non-blocking."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                         if a.dtype == np.uint32 else np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _Pending:
    """Outputs of one dispatched step, on their way to the host.

    On the card the device-to-host copies are issued non-blocking (into
    pinned host memory) right after the step is enqueued; `get` waits on an
    event recorded behind them. With tracing on, the step's device counts
    (core/trace.count_device) ride along as one more output, added to the
    counters by `get`."""

    def __init__(self, outs, device: torch.device):
        self.event = None
        counts = trace.take_device(device)
        with trace.span("outputs"):
            self.names = None
            if counts is not None:
                self.names, t = counts
                outs = tuple(outs) + (t,)
            if device.type == "cuda":
                self.host = tuple(t.to("cpu", non_blocking=True)
                                  for t in outs)
                self.event = torch.cuda.Event()
                self.event.record()
                if trace.enabled():
                    trace.count("d2h_bytes",
                                sum(t.nbytes for t in self.host))
            else:
                self.host = tuple(outs)

    def get(self):
        with trace.span("wait"):
            if self.event is not None:
                self.event.synchronize()
            host = tuple(t.numpy() for t in self.host)
        if self.names is None:
            return host
        for name, v in zip(self.names, host[-1].tolist()):
            trace.count(name, v)
        return host[:-1]


class QueryEngine:
    """dist probe + leaf-level ML over one DeviceIndex on one device.

    Probe layouts (chosen at init, as the reference's):
      * 'hybrid' -- a bucket-row table (count word + first C0 entries per
        row, the leaf bitmask embedded ('embed', W <= 2) or the color id
        stored ('se')), probed with ONE row gather + an epilogue kernel;
        deep buckets spill to a compacted heavy-bucket table or CSR rescan;
      * 'event' -- indexes without bitmasks (or FORCE_EVENT): 'se' bucket
        rows, matched events expanded through the per-color leaf-slot CSR
        and deduped by sort (event_probe.py), stage 2 on lanes joined from
        them;
      * 'csr' -- the flat entry array + offset CSR with a bounded scan
        loop and a top-k heavy tail, when no bucket-row table fits
        DIRECT_MEM_CAP."""

    def __init__(self, dindex: DeviceIndex, hdist_th: int = 4,
                 device="cuda"):
        self.device = resolve_device(device)
        self.di = dindex
        self.th = int(hdist_th)
        self.lsh = dindex.lsh
        self.S = dindex.nleafslots
        self.W = (dindex.se_mask.shape[1] if dindex.se_mask is not None
                  else (self.S + 31) // 32)
        dev = self.device
        self._rho_slot = torch.from_numpy(
            np.asarray(dindex.rho_slot, np.float64)).to(dev)
        self._expand = make_expander(self.S, self.W)
        self._llh = make_llh(self.lsh.k, self.lsh.h, self.th)
        self._rows = _RowMap(dindex, dev)
        self._heavy_frac = self._measure_heavy_frac(dindex)
        self._heavy_cap_override = None    # test hook: tiny heavy caps
        self._lane_cap_override = None     # test hook: tiny lane caps
        self.escalations = 0               # tier / exact re-runs so far
        self._init_tables(dindex)

    @staticmethod
    def _measure_heavy_frac(di: DeviceIndex) -> float:
        """Expected fraction of probe lanes whose bucket exceeds the dense
        slots, from the index's own bucket-depth histogram (see
        krepp_tpu.query.engine.QueryEngine._measure_heavy_frac)."""
        C0 = min(DENSE_SLOTS, max(1, di.max_bucket))
        counts = np.diff(di.row_start)
        total = int(counts.sum())
        if total == 0 or di.max_bucket <= C0:
            return 0.0
        heavy = counts > C0
        entry_frac = float(counts[heavy].sum()) / total
        rand_frac = float(np.count_nonzero(heavy)) / max(int(di.nrows_u), 1)
        res_frac = (float(np.count_nonzero(di.resident))
                    / max(len(di.resident), 1))
        return min(0.5, HEAVY_SAFETY * res_frac
                   * max(rand_frac, EXACT_MIX * entry_frac))

    def _heavy_caps(self, Np: int, tier: int):
        """(K, K2): heavy-tail and ultra-deep compaction caps for Np probe
        lanes at a capacity tier (4x per tier)."""
        frac = self._heavy_frac
        K0 = int(np.ceil(Np * frac)) if frac > 0 else Np // HEAVY_DIV
        K0 = max(4096, K0)
        ov = self._heavy_cap_override
        if ov is not None:
            K0 = ov
        K = min(Np, K0 << (2 * tier))
        K2 = min(K, max(256 if ov is None else 1, Np // DEEP_DIV)
                 << (2 * tier))
        return K, K2

    # --------------------------------------------------------- table builds
    def _init_tables(self, di: DeviceIndex) -> None:
        """Choose the probe layout, build its tables on the host and place
        them on device: (slots, enc_se, row_start, row_ids, mask_tab,
        heavy_tab) in hybrid mode, (slots, enc_se, row_start, row_ids,
        leaf_off, leaf_slots, heavy_tab) in event mode, (enc_se, row_start,
        row_ids, mask_tab) in CSR mode."""
        dev = self.device
        enc_se = np.stack([di.enc_v, di.se_v.astype(np.uint32)], axis=1)
        csr = (_i32(enc_se, dev),
               torch.from_numpy(di.row_start.astype(np.int64)).to(dev),
               None if di.row_ids is None
               else torch.from_numpy(di.row_ids.astype(np.int64)).to(dev))
        nrows_dense = di.nrows_u if di.row_ids is None else None
        self.C0 = min(DENSE_SLOTS, max(1, di.max_bucket))
        if di.se_mask is None or FORCE_EVENT:
            self.mode = "event"
            self.hflavor = "se"
            _check_leaf_ranges(di)
            slots, _ = build_hybrid_slots(
                di.row_start, di.enc_v, di.se_v, None, nrows_dense,
                max(1, di.max_bucket), self.W, flavor="se")
            if slots is None:
                raise RuntimeError(
                    "the event probe's bucket-row table exceeds "
                    f"DIRECT_MEM_CAP ({DIRECT_MEM_CAP} bytes) on one device; "
                    "shard the index over N devices with --mesh 1xN")
            heavy_tab = None
            if di.max_bucket > self.C0:
                heavy_tab = self._build_heavy_tab(di, slots)
            self._tables = (_i32(slots, dev),) + csr + (
                torch.from_numpy(di.leaf_csr_off.astype(np.int64)).to(dev),
                torch.from_numpy(di.leaf_csr_slots.astype(np.int32)).to(dev),
                None if heavy_tab is None else _i32(heavy_tab, dev))
            return
        csr = csr + (_i32(di.se_mask, dev),)
        slots, flavor = build_hybrid_slots(
            di.row_start, di.enc_v, di.se_v, di.se_mask, nrows_dense,
            max(1, di.max_bucket), self.W)
        if slots is None:
            self.mode = "csr"
            self.hflavor = None
            self._tables = csr
            return
        self.mode = "hybrid"
        self.hflavor = flavor
        heavy_tab = None
        if di.max_bucket > self.C0:
            heavy_tab = self._build_heavy_tab(di, slots)
        self._tables = (_i32(slots, dev),) + csr + (
            None if heavy_tab is None else _i32(heavy_tab, dev),)

    def _build_heavy_tab(self, di: DeviceIndex, slots: np.ndarray):
        """Side table with one padded row per heavy bucket (depth > C0):
        word 0 = true count, then TP (enc, aux) entry pairs, aux the mask
        word when W == 1 in hybrid mode, else the se id (the hybrid tail
        gathers the mask words by it, the event probe expands it; the
        reference's use_mask and aux="se"). The owning slots row's count
        word is patched to min(cnt, 255) | (heavy_id + 1) << 8 (see the
        reference). Returns None (CSR tail) when the id doesn't fit 24 bits
        or the table would exceed HEAVY_TAB_CAP."""
        counts = np.diff(di.row_start)
        heavy = np.flatnonzero(counts > self.C0)
        n_h = len(heavy)
        if n_h == 0 or n_h >= (1 << 24) - 1:
            return None
        hc = counts[heavy]
        q_row = float(np.quantile(hc, 0.999))
        hs = np.sort(hc)
        wcum = np.cumsum(hs, dtype=np.float64)
        q_mass = float(hs[min(np.searchsorted(wcum, 0.995 * wcum[-1]),
                              len(hs) - 1)])
        TP = int(np.ceil(max(q_row, q_mass)))
        TP = min(max(TP, 4), int(di.max_bucket), TAIL_UNROLL)
        while TP > 4 and n_h * (1 + 2 * TP) * 4 > HEAVY_TAB_CAP:
            TP -= 1
        if n_h * (1 + 2 * TP) * 4 > HEAVY_TAB_CAP:
            return None
        htab = np.zeros((n_h, 1 + 2 * TP), np.uint32)
        htab[:, 0] = counts[heavy].astype(np.uint32)
        starts = di.row_start[heavy]
        ends = di.row_start[heavy + 1]
        for j in range(TP):
            pos = starts + j
            valid = pos < ends
            pv = np.where(valid, pos, 0)
            htab[:, 1 + 2 * j] = np.where(valid, di.enc_v[pv], 0)
            if self.W == 1 and self.mode == "hybrid":
                aux = di.se_mask[di.se_v[pv]][:, 0]
            else:
                aux = di.se_v[pv].astype(np.uint32)
            htab[:, 2 + 2 * j] = np.where(valid, aux, 0)
        slots[heavy, 0] = (np.minimum(counts[heavy], 255).astype(np.uint32)
                           | ((np.arange(n_h, dtype=np.uint32) + 1) << 8))
        return htab

    # ------------------------------------------------------------- stage 1
    def _route_rows(self, row_ids, urow, resident):
        """urow -> (sidx into the slots table, hrow into row_start, found).

        Sparse tables binary-search the sorted nonempty-row ids and send
        missed probes to the trailing all-zero row."""
        if row_ids is None:
            return urow, urow, resident
        nnz = row_ids.shape[0]
        pos = torch.searchsorted(row_ids, urow)
        posc = torch.clamp(pos, max=nnz - 1)
        found = resident & (row_ids[posc] == urow)
        sidx = torch.where(found, posc, nnz)
        return sidx, posc, found

    def _strand_hashes(self, codes, lengths):
        k = self.lsh.k
        P = codes.shape[1] - k + 1
        rix_or, rix_rc, res_or, res_rc, valid_w = codec.strand_hashes(
            codes, self.lsh)
        t_idx = torch.arange(P, dtype=torch.int32, device=codes.device)
        valid = valid_w & (t_idx[None, :] <= lengths[:, None] - k)
        onmers = valid.sum(dim=1, dtype=torch.int32)
        return (torch.stack([rix_or, rix_rc]), torch.stack([res_or, res_rc]),
                valid, onmers)

    def _packed_epilogue_ok(self, P: int) -> bool:
        """Gate of the packed epilogue kernel: embed rows, one mask word,
        <= 2 dense slots, <= 6 distance classes, <= 255 positions."""
        return (self.hflavor == "embed" and self.W == 1 and self.C0 <= 2
                and self.th + 1 <= MAX_X and P <= MAX_P and self.S <= MAX_S)

    def _dense_epilogue(self, d, mask_tab, res2, light, B: int, P: int):
        """First-C0-slot probe epilogue -> (hist [2B,S,X], minall [2B]);
        d: gathered rows [2, B, P, width]. The packed kernel where its gate
        allows, else the tiles kernel ('se' rows read their mask words
        through mask_tab inside it)."""
        N = 2 * B
        args = (res2.reshape(N, P), light.reshape(N, P),
                d.reshape(N, P, d.shape[-1]))
        if self._packed_epilogue_ok(P):
            return probe_hist_packed(*args, self.th, self.C0, self.S)
        return probe_hist_tiles(
            *args, mask_tab if self.hflavor == "se" else None, self.th,
            self.C0, self.W, self.S)

    def _hybrid_core(self, slots_d, enc_se, row_start, mask_tab, sidx, hrow,
                     resident, res2, max_bucket: int, tier: int = 0,
                     heavy_tab=None):
        """Hybrid probe body over pre-routed rows [2, B, P]. Returns
        (hist [2B, S, X], minall [2B], overflow bool tensor). With tracing
        on, counts the probe positions sent to the heavy tail (resident,
        bucket deeper than C0: `heavy_lanes`) on the card."""
        th, S, C0 = self.th, self.S, self.C0
        X = th + 1
        dev = res2.device
        _, B, P = sidx.shape
        N = 2 * B
        d = slots_d[sidx]                                # [2, B, P, width]
        word0 = d[..., 0]
        # with a heavy table the count word packs cnt | (hid+1) << 8
        cnt_c = word0 & 255 if heavy_tab is not None else word0
        cnt = torch.where(resident, cnt_c, 0)
        heavy = cnt > C0
        light = resident & ~heavy
        hist, minall = self._dense_epilogue(d, mask_tab, res2, light, B, P)

        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        if max_bucket <= C0:
            return hist, minall, overflow
        Np = N * P
        K, K2 = self._heavy_caps(Np, tier)
        hidx, nheavy, blk_over = compact_mask_indices_strided(
            heavy.reshape(Np), K)
        trace.count_device("heavy_lanes", nheavy)
        overflow = (nheavy > K) | blk_over
        Kl = hidx.shape[0]
        # compacted indices ascend, so seg is sorted; hidx < Np marks live
        seg = torch.clamp(hidx // P, max=N - 1).to(torch.int64)
        live = hidx < Np
        safe_l = torch.clamp(hidx, max=Np - 1).to(torch.int64)
        hres = res2.reshape(Np)[safe_l]
        nk = max(enc_se.shape[0], 1)
        start = None
        if heavy_tab is not None:
            # one single-row gather per heavy lane: (count, first MB pairs)
            MB = (heavy_tab.shape[1] - 1) // 2
            hrow_t = heavy_tab[heavy_id(word0.reshape(Np)[safe_l],
                                        heavy_tab.shape[0])]  # [K, 1+2*MB]
            hcnt = torch.where(live, hrow_t[:, 0], 0)
            penc = hrow_t[:, 1::2]
            hd = codec.hdist_lr32(penc, hres[:, None])
            aux = hrow_t[:, 2::2]                        # mask word | se
            jj = torch.arange(MB, dtype=torch.int32, device=dev)
            inb = jj[None, :] < torch.clamp(hcnt, max=MB)[:, None]
            match = inb & (hd <= th)
            if self.W == 1:
                msk = torch.where(match, aux, 0)[..., None]   # [K, MB, 1]
            else:
                sev = torch.where(match, aux, 0).to(torch.int64)
                msk = mask_tab[sev]                          # [K, MB, W]
        else:
            # CSR tail: route through row_start
            hurow = hrow.reshape(Np)[safe_l]
            start = row_start[hurow]
            hcnt = torch.where(live, row_start[hurow + 1] - start,
                               0).to(torch.int32)
            MB = min(max_bucket, TAIL_UNROLL)
            jj = torch.arange(MB, dtype=torch.int32, device=dev)
            idx = torch.clamp(start[:, None] + jj[None, :], max=nk - 1)
            pair = enc_se[idx]                           # [K, MB, 2]
            hd = codec.hdist_lr32(pair[..., 0], hres[:, None])
            inb = jj[None, :] < torch.clamp(hcnt, max=MB)[:, None]
            match = inb & (hd <= th)
            sev = torch.where(match, pair[..., 1], 0).to(torch.int64)
            msk = mask_tab[sev]                          # [K, MB, W]
        # per-class leaf planes, OR-ed over the MB candidates (one bucket
        # may repeat colors)
        Mm = _or_reduce(torch.stack([
            torch.where((match & (hd == x))[..., None], msk, 0)
            for x in range(X)]), dim=2)                   # [X, K, W]
        hgmin = torch.where(match, hd, HD_SENTINEL).amin(dim=1)

        if max_bucket > MB:
            # tier B: ultra-deep buckets finish with the scan loop
            deep = live & (hcnt > MB)
            didx, ndeep = compact_mask_indices(deep, K2)
            overflow = overflow | (ndeep > K2)
            dsafe = torch.clamp(didx, max=Kl - 1).to(torch.int64)
            dlive = didx < Kl
            if start is None:
                start_d = row_start[hrow.reshape(Np)[safe_l[dsafe]]]
            else:
                start_d = start[dsafe]
            dcnt = torch.where(dlive, hcnt[dsafe], 0)
            hmax = (min(host_int(dcnt.max()), max_bucket) if dcnt.numel()
                    else 0)
            Mm2 = torch.zeros((X, dsafe.shape[0], self.W), dtype=torch.int32,
                              device=dev)
            gmin2 = torch.full((dsafe.shape[0],), HD_SENTINEL,
                               dtype=torch.int32, device=dev)
            Mm2, gmin2 = _scan_loop(enc_se, mask_tab, start_d, dcnt,
                                    hres[dsafe], th, self.W, MB, hmax,
                                    Mm2, gmin2)
            host_wait(dev)              # the mask index below syncs
            di_live = dsafe[dlive]
            Mm[:, di_live] = Mm[:, di_live] | Mm2[:, dlive]
            hgmin = hgmin.scatter_reduce(
                0, dsafe, torch.where(dlive, gmin2, HD_SENTINEL), "amin")
        # per-(lane, leaf) minimum class -> one-hot counts per read, in lane
        # chunks that keep the [rows, S, X] one-hot under ONEHOT_ELEMS
        mh = torch.full((Kl, S), X, dtype=torch.int32, device=dev)
        for x in range(X - 1, -1, -1):
            mh = torch.where(self._expand(Mm[x]) != 0, x, mh)
        xs = torch.arange(X, dtype=torch.int32, device=dev)
        rows = max(1, ONEHOT_ELEMS // (S * X))
        for lo in range(0, Kl, rows):
            onehot = ((mh[lo: lo + rows, :, None] == xs)
                      & live[lo: lo + rows, None, None])
            hist.index_add_(0, seg[lo: lo + rows], onehot.to(torch.int32))
        hgmin = torch.where(live, hgmin, HD_SENTINEL)
        minh = torch.full((N,), HD_SENTINEL, dtype=torch.int32, device=dev)
        minh = minh.scatter_reduce(0, seg, hgmin, "amin")
        return hist, torch.minimum(minall, minh), overflow

    def _probe_hybrid(self, tables, codes, lengths, tier: int = 0):
        """Dense bucket-row probe + compacted heavy tail, exact up to the
        heavy-tail capacity (overflow -> tier re-runs, then the exact CSR
        rescan). Per-(read, position, leaf) minimum Hamming distance
        histogram (ref: src/query.hpp:153-176)."""
        slots_d, enc_se, row_start, row_ids, mask_tab, heavy_tab = tables
        with trace.span("hash"):
            rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
            urow, resident = self._rows(rix2, valid[None])   # [2, B, P]
            sidx, hrow, resident = self._route_rows(row_ids, urow, resident)
        with trace.span("probe"):
            hist, minall, overflow = self._hybrid_core(
                slots_d, enc_se, row_start, mask_tab, sidx, hrow, resident,
                res2, self.di.max_bucket, tier, heavy_tab)
            B = codes.shape[0]
            hist = hist.reshape(2, B, self.S, self.th + 1)
            minall = minall.reshape(2, B)
        return (hist[0], hist[1], minall[0], minall[1], onmers, overflow)

    def _probe_csr(self, tables, codes, lengths):
        """CSR-mode probe, strand by strand through the top-k bounded scan
        (ref: engine.py _strand_probe)."""
        enc_se, row_start, row_ids, mask_tab = tables
        with trace.span("hash"):
            rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
        outs = []
        with trace.span("probe"):
            for strand in range(2):
                urow, resident = self._rows(rix2[strand], valid)
                start, cnt = _csr_bucket_slices(row_start, row_ids, urow,
                                                resident)
                outs.append(probe_strand(
                    enc_se, mask_tab, self._expand, start, cnt, res2[strand],
                    self.th, self.W, self.S, self.di.max_bucket))
        (hist_or, min_or, ov_or), (hist_rc, min_rc, ov_rc) = outs
        return hist_or, hist_rc, min_or, min_rc, onmers, ov_or | ov_rc

    def _probe_csr_exact(self, tables, codes, lengths):
        """Exact full-depth CSR scan of every probe: CSR mode's exact run
        and the hybrid overflow fallback. tables: the CSR tables."""
        enc_se, row_start, row_ids, mask_tab = tables
        with trace.span("hash"):
            rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
            urow, resident = self._rows(rix2, valid[None])
            start, cnt = _csr_bucket_slices(row_start, row_ids, urow,
                                            resident)
        B = codes.shape[0]
        P = urow.shape[2]
        N = 2 * B
        with trace.span("probe"):
            hist, minall = probe_strand_full(
                enc_se, mask_tab, self._expand, start.reshape(N, P),
                cnt.reshape(N, P), res2.reshape(N, P),
                self.th, self.W, self.S, self.di.max_bucket)
            hist = hist.reshape(2, B, self.S, self.th + 1)
            minall = minall.reshape(2, B)
        return (hist[0], hist[1], minall[0], minall[1], onmers,
                torch.zeros((), dtype=torch.bool, device=codes.device))

    def _probe_impl(self, tables, codes, lengths, exact: bool = False,
                    tier: int = 0):
        """(hist_or, hist_rc, minall_or, minall_rc, onmers, overflow) of the
        hybrid and CSR modes (event mode runs `_event_lanes`)."""
        csr = tables if self.mode == "csr" else tables[1:5]
        if exact:
            return self._probe_csr_exact(csr, codes, lengths)
        if self.mode == "csr":
            return self._probe_csr(csr, codes, lengths)
        return self._probe_hybrid(tables, codes, lengths, tier)

    # ------------------------------------------------------- event mode
    def _event_caps(self, B: int, P: int, tier: int):
        """(E, KH, CAP_L): per-probe ultra-deep matches, heavy probes and
        leaf events at a capacity tier, 4x per tier (the reference's
        values: its docstring says 16x, its code shifts by 2 * tier)."""
        Np = 2 * B * P
        rf = self._res_frac()
        E = min(8 << (2 * tier), max(self.di.max_bucket, 1))
        KH = min(Np, max(4096, int(Np * rf) // 4) << (2 * tier))
        CAP_L = max(1 << 16, int(Np * rf) // 4) << (2 * tier)
        return E, KH, CAP_L

    def _res_frac(self) -> float:
        """Fraction of probe lanes whose LSH residue is resident."""
        return float(np.count_nonzero(self.di.resident)) / max(self.lsh.m, 1)

    def _resident_cap(self, Np: int, tier: int):
        """Capacity of the resident-lane compaction (None: no compaction).

        Resident lanes are ~Binomial(Np, res_frac): a 1.02x + 8k margin,
        4x per tier, so a batch of correlated reads that overflows tier 0
        recovers at a later tier (the reference keeps one cap at every
        tier; ROADMAP Queue 3)."""
        rf = self._res_frac()
        if rf >= 0.95:
            return None
        KR = (int(Np * rf * 1.02) + 8192) << (2 * tier)
        KR = (KR + 1023) & ~1023
        return None if KR >= Np else KR

    def _event_lane_join(self, nb_lane, leaf_lane, hist_lanes, K: int,
                         B: int):
        """(strand-read, leaf) event lanes -> stage-2 lane inputs (idx, lv,
        h_or, h_rc, lane_over): lanes sorted by (read, leaf, strand), each
        or/rc pair merged into one (read, leaf) group, groups compacted to
        K slots in ascending b*S+s order -- the lane set and order the
        dense extraction gives, with no [B, S] array."""
        S = self.S
        X = self.th + 1
        dev = nb_lane.device
        CAP = nb_lane.shape[0]
        N = 2 * B
        BS = B * S
        K = min(K, CAP)
        valid = nb_lane < N
        strand = (nb_lane >= B).to(torch.int64)
        b = nb_lane.long() - strand * B
        big = BS << 1
        key = torch.where(valid, ((b * S + leaf_lane.long()) << 1) | strand,
                          big).to(torch.int32)
        ks, perm = torch.sort(key, stable=True)
        hist_s = hist_lanes[perm]
        vs = ks < big
        gkey = ks >> 1
        strand_s = ks & 1
        first = (gkey != torch.cat([gkey.new_full((1,), -1), gkey[:-1]])) & vs
        gid = torch.clamp(torch.cumsum(first.to(torch.int32), 0) - 1, min=0)

        def strand_sum(s):
            w = ((strand_s == s) & vs).to(torch.int32)[:, None]
            z = torch.zeros((CAP, X), dtype=torch.int32, device=dev)
            return z.index_add_(0, gid, w * hist_s)[:K]

        gkey_g = torch.full((CAP,), -1, dtype=torch.int32, device=dev)
        gkey_g = gkey_g.scatter_reduce_(0, gid, torch.where(vs, gkey, -1),
                                        "amax", include_self=False)
        ngroups = first.sum(dtype=torch.int32)
        lv = torch.arange(K, dtype=torch.int32, device=dev) < ngroups
        idx = torch.where(lv, torch.clamp(gkey_g[:K], min=0),
                          BS).to(torch.int32)
        h_or = torch.where(lv[:, None], strand_sum(0), 0)
        h_rc = torch.where(lv[:, None], strand_sum(1), 0)
        return idx, lv, h_or, h_rc, ngroups > K

    def _event_lanes(self, tables, codes, lengths, leaf_ok,
                     lane_cap: Optional[int], exact: bool, tier: int):
        """Event-mode probe + lane join + stage 2 (no [B, S] array);
        "exact" runs at tier >= 2, since capacities escalate on the host
        (fetch_prefetched)."""
        (slots_d, enc_se, row_start, row_ids, leaf_off, leaf_slots,
         heavy_tab) = tables
        with trace.span("hash"):
            rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
            urow, resident = self._rows(rix2, valid[None])   # [2, B, P]
            sidx, hrow, resident = self._route_rows(row_ids, urow, resident)
        B, P = codes.shape[0], urow.shape[2]
        etier = max(tier, 2) if exact else tier
        E, KH, CAP_L = self._event_caps(B, P, etier)
        with trace.span("probe"):
            nb_lane, leaf_lane, hist_lanes, minall, ov = event_probe_lanes(
                slots_d, enc_se, row_start, leaf_off, leaf_slots, sidx, hrow,
                resident, res2, self.th, self.C0, self.S, self.di.max_bucket,
                E, KH, CAP_L, heavy_tab=heavy_tab,
                KR=self._resident_cap(2 * B * P, etier))
            minall = minall.reshape(2, B)
        BS = B * self.S
        K = BS if lane_cap is None else min(BS, lane_cap)
        with trace.span("lanes"):
            idx, lv, h_or, h_rc, lane_over = self._event_lane_join(
                nb_lane, leaf_lane, hist_lanes, K, B)
        L = self._stage2_core(idx, lv, h_or, h_rc, minall[0], minall[1],
                              onmers, leaf_ok, lane_over)
        return L, onmers, ov

    # ------------------------------------------------------------- stage 2
    def _probe_and_lanes(self, tables, codes, lengths, leaf_ok,
                         lane_cap: Optional[int], exact: bool, tier: int):
        """Probe + lane extraction -> (L dict, onmers, probe_overflow).

        Event mode stays in lane form end to end (_event_lanes); the other
        modes probe dense histograms and run stage 2 on K = min(B*S,
        lane_cap) lanes extracted from them (lane_cap None: all B*S)."""
        if self.mode == "event":
            return self._event_lanes(tables, codes, lengths, leaf_ok,
                                     lane_cap, exact, tier)
        probe_out = self._probe_impl(tables, codes, lengths, exact, tier)
        BS = codes.shape[0] * self.S
        K = BS if lane_cap is None else min(BS, lane_cap)
        L = self._stage2_lanes(*probe_out[:5], leaf_ok, K)
        return L, probe_out[4], probe_out[5]

    def _stage2_lanes(self, hist_or, hist_rc, minall_or, minall_rc, onmers,
                      leaf_ok, K: int):
        """Leaf-level filtering + ML + strand resolution on lanes compacted
        to K slots (ref: src/query.cpp:96-139); n_lanes > K raises
        lane_over and fetch_prefetched re-runs at a larger capacity."""
        B = hist_or.shape[0]
        S = self.S
        BS = B * S
        X = self.th + 1
        with trace.span("lanes"):
            anym = ((hist_or.sum(dim=-1) > 0) | (hist_rc.sum(dim=-1) > 0))
            idx, nset = compact_mask_indices(anym.reshape(-1), K)
            lane_over = nset > K
            lv = idx < BS
            safe = torch.clamp(idx, max=BS - 1).to(torch.int64)
            h_or = torch.where(lv[:, None], hist_or.reshape(BS, X)[safe], 0)
            h_rc = torch.where(lv[:, None], hist_rc.reshape(BS, X)[safe], 0)
        return self._stage2_core(idx, lv, h_or, h_rc, minall_or, minall_rc,
                                 onmers, leaf_ok, lane_over)

    def _stage2_core(self, idx, lv, h_or, h_rc, minall_or, minall_rc,
                     onmers, leaf_ok, lane_over):
        """Lane-form stage 2 on pre-extracted (read, leaf) lanes.

        idx: [K] int32 ascending b*S+s keys (sentinel B*S for empty);
        h_or/h_rc: [K, X] int32 per-strand first-match histograms. With
        tracing on, counts its present lanes (`stage2_lanes`) and the
        matched positions of each read's closest leaf
        (`matched_positions`) on the card."""
        with trace.span("stage2"):
            L = self._stage2_body(idx, lv, h_or, h_rc, minall_or, minall_rc,
                                  onmers, leaf_ok, lane_over)
            if trace.enabled():
                trace.count_device("stage2_lanes", L["present_l"].sum())
                trace.count_device("matched_positions", L["hist_c"].sum())
        return L

    def _stage2_body(self, idx, lv, h_or, h_rc, minall_or, minall_rc,
                     onmers, leaf_ok, lane_over):
        th = self.th
        X = th + 1
        dev = h_or.device
        B = minall_or.shape[0]
        S = self.S
        BS = B * S
        NB = B + 1
        xs = torch.arange(X, dtype=torch.int32, device=dev)

        safe = torch.clamp(idx, max=BS - 1).to(torch.int64)
        lb = safe // S                                        # owning read
        ls = safe - lb * S                                    # leaf slot
        seg = torch.where(lv, lb, B)                          # sorted ids
        lok = leaf_ok[ls]
        mc_or = h_or.sum(dim=-1, dtype=torch.int32)
        mc_rc = h_rc.sum(dim=-1, dtype=torch.int32)

        def keep_of(h, mc, minall):
            present = (mc > 0) & lok
            minhd = torch.where(h > 0, xs[None, :], HD_SENTINEL).amin(dim=-1)
            filt = torch.where(minall < HD_SENTINEL, 2 * minall + 1,
                               2 * HD_SENTINEL)
            return present & (minhd <= filt[lb])

        keep_or = keep_of(h_or, mc_or, minall_or)
        keep_rc = keep_of(h_rc, mc_rc, minall_rc)

        onm_l = onmers[lb]
        uc_or = (onm_l - mc_or).to(F)
        uc_rc = (onm_l - mc_rc).to(F)
        rho_l = self._rho_slot.to(dev)[ls]   # sharded: a data row's card
        bx_or = (h_or * xs[None, :]).sum(dim=-1, dtype=torch.int32).to(F)
        bx_rc = (h_rc * xs[None, :]).sum(dim=-1, dtype=torch.int32).to(F)
        A2 = torch.cat([mc_or.to(F), mc_rc.to(F)])
        Bx2 = torch.cat([bx_or, bx_rc])
        uc2 = torch.cat([uc_or, uc_rc])
        rho2 = torch.cat([rho_l, rho_l])
        # the solver runs only on strand-lanes that pass the keep gate
        keep2 = torch.cat([keep_or, keep_rc])
        d2, v2 = brent_llh(A2, Bx2, uc2, rho2, keep2, self.lsh.k, self.lsh.h,
                           th)
        K = idx.shape[0]
        d_or = torch.where(keep_or, d2[:K], D_MAX)
        d_rc = torch.where(keep_rc, d2[K:], D_MAX)
        v_or = torch.where(keep_or, v2[:K], 0.0)
        v_rc = torch.where(keep_rc, v2[K:], 0.0)

        # strand choice for the resolved map (ref: src/query.cpp:126-134)
        or_wins = (d_rc > d_or) | ((d_rc == d_or) & (mc_rc < mc_or))
        use_or = torch.where(keep_rc, or_wins & keep_or, keep_or)
        use_rc = keep_rc & ~use_or
        present_l = use_or | use_rc

        hist_f = torch.where(use_or[:, None], h_or, h_rc)
        d_f = torch.where(use_or, d_or, torch.where(use_rc, d_rc, D_MAX))
        v_f = torch.where(use_or, v_or, v_rc)
        mc_f = torch.where(use_or, mc_or, mc_rc)
        uc_f = torch.where(use_or, uc_or, uc_rc)

        # closest scan (ref: src/query.cpp:103-137): or entries first, then
        # rc; "<=" so later wins ties; residual ties go to the higher slot
        def closest(keep, dm):
            cand, at = _f64_segment_min(dm, keep, seg, NB, lb)
            slot = torch.full((NB,), -1, dtype=torch.int64, device=dev)
            slot = slot.scatter_reduce(0, seg, torch.where(at, ls, -1),
                                       "amax")[:B]
            return cand[:B], slot

        cand_or, slot_or = closest(keep_or, d_or)
        has_or = slot_or >= 0
        best_d = torch.where(has_or, cand_or, D_MAX)
        best_slot = torch.where(has_or, slot_or, -1)
        cand_rc, slot_rc = closest(keep_rc, d_rc)
        rc_wins = (slot_rc >= 0) & (cand_rc <= best_d)
        best_d = torch.where(rc_wins, cand_rc, best_d)
        best_slot = torch.where(rc_wins, slot_rc, best_slot).to(torch.int32)
        best_strand = rc_wins.to(torch.int32)

        # override the resolved map at the closest slot with the closest
        # version (ref: src/query.cpp:136-138)
        bs_l = best_slot[lb]
        is_best = lv & (bs_l >= 0) & (ls == bs_l)
        rc_best = is_best & (best_strand[lb] == 1)
        or_best = is_best & (best_strand[lb] == 0)
        hist_f = torch.where(rc_best[:, None], h_rc, hist_f)
        hist_f = torch.where(or_best[:, None], h_or, hist_f)
        d_f = torch.where(rc_best, d_rc, torch.where(or_best, d_or, d_f))
        v_f = torch.where(rc_best, v_rc, torch.where(or_best, v_or, v_f))
        mc_f = torch.where(rc_best, mc_rc, torch.where(or_best, mc_or, mc_f))
        uc_f = torch.where(rc_best, uc_rc, torch.where(or_best, uc_or, uc_f))
        present_l = present_l | is_best

        # closest-candidate summary: is_best marks one lane per read, so
        # these segment sums are single-lane selects (exact in any order)
        def best_sum(x):
            return _f64_segment_select(x, is_best, seg, NB)[:B]

        hist_c = best_sum(hist_f).to(F)
        uc_c = best_sum((onm_l - mc_f).to(torch.int32)).to(F)
        has_best = best_slot >= 0
        rho_c = torch.where(has_best, best_sum(rho_l), 0.0)
        v_c = torch.where(has_best, best_sum(v_f), 0.0)
        return dict(idx=idx, lv=lv, lb=lb, ls=ls, lane_over=lane_over,
                    present_l=present_l, hist_f=hist_f, d_f=d_f, v_f=v_f,
                    mc_f=mc_f, uc_f=uc_f, rho_l=rho_l, best_slot=best_slot,
                    best_d=best_d, hist_c=hist_c, uc_c=uc_c, rho_c=rho_c,
                    v_c=v_c)

    def _scatter_back(self, L, B: int, onmers):
        """Lane dict -> the dense 14-tuple (full out_mode)."""
        S = self.S
        BS = B * S
        X = self.th + 1
        dev = onmers.device
        idx = L["idx"].to(torch.int64)

        def scat(init, val):
            buf = torch.cat([init, init[:1]])    # slot BS takes sentinels
            buf[idx] = val
            return buf[:BS].reshape((B, S) + val.shape[1:])

        lb = L["lb"]
        ratio_l = 2.0 * (self._llh(L["d_f"], L["hist_c"][lb], L["uc_c"][lb],
                                   L["rho_c"][lb]) - L["v_c"][lb])
        present = scat(torch.zeros((BS,), dtype=torch.bool, device=dev),
                       L["present_l"])
        hist_f = scat(torch.zeros((BS, X), dtype=torch.int32, device=dev),
                      L["hist_f"])
        d_f = scat(torch.full((BS,), D_MAX, dtype=F, device=dev), L["d_f"])
        v_f = scat(torch.zeros((BS,), dtype=F, device=dev), L["v_f"])
        mc_f = scat(torch.zeros((BS,), dtype=torch.int32, device=dev),
                    L["mc_f"])
        uc_base = onmers.to(F).repeat_interleave(S)
        uc_f = scat(uc_base, L["uc_f"])
        # absent lanes carry d = D_MAX: one read-constant ratio (NaN through
        # log(1 - D_MAX), as in the reference package)
        ratio_row = 2.0 * (self._llh(
            torch.full((B,), D_MAX, dtype=F, device=dev), L["hist_c"],
            L["uc_c"], L["rho_c"]) - L["v_c"])
        ratio = scat(ratio_row.repeat_interleave(S), ratio_l)
        rho = self._rho_slot[None, :].expand(B, S).contiguous()
        return (present, hist_f, d_f, v_f, mc_f, uc_f, rho,
                L["best_slot"], L["best_d"], L["hist_c"], L["uc_c"],
                L["rho_c"], L["v_c"], ratio)

    def _full_impl(self, tables, packed, vbits, lengths, leaf_ok,
                   exact: bool = False, out_mode: str = "full",
                   tier: int = 0, lane_exact: bool = False):
        """Probe + stage 2 over 2-bit-packed reads. out_mode selects the
        output set: "dist" (what report_distances consumes), "dist_ratio"
        (+ the closest-candidate summary) or "full" (per-leaf state)."""
        L = packed.shape[1] * 16
        with trace.span("hash"):
            codes = codec.unpack_codes(packed, lengths, L, vbits)
        B = codes.shape[0]
        S = self.S
        base_cap = self._lane_cap_override or max(8 * B, 4096)
        lane_cap = None if (exact or lane_exact) else min(
            B * S, base_cap << (2 * tier))
        lanes, onmers, probe_ov = self._probe_and_lanes(
            tables, codes, lengths, leaf_ok, lane_cap, exact, tier)
        with trace.span("outputs"):
            return self._outputs(lanes, onmers, probe_ov, B, out_mode)

    def _outputs(self, lanes, onmers, probe_ov, B: int, out_mode: str):
        """The step's output set of `_full_impl` from its stage-2 lanes."""
        S = self.S
        # overflow bit-flag word: bit 0 = probe capacity (heavy tail),
        # bit 1 = stage-2 lane cap; they escalate independently
        overflow = (probe_ov.to(torch.int32)
                    | lanes["lane_over"].to(torch.int32) * 2)
        if out_mode in ("dist", "dist_ratio"):
            present = torch.zeros((B * S + 1,), dtype=torch.bool,
                                  device=onmers.device)
            present[lanes["idx"].to(torch.int64)] = lanes["present_l"]
            bits = codec.pack_bits_device(present[:B * S].reshape(B, S))
            # present-lane distances in index order: the first n entries
            # are exactly np.flatnonzero(present)
            K = min(B * S, max(8 * B, 1024))
            pl = lanes["present_l"]
            pidx, nset = compact_mask_indices(pl, K)
            dval = lanes["d_f"][torch.clamp(pidx, max=pl.shape[0] - 1)
                                .to(torch.int64)]
            fetch_over = nset > K
            base = (bits, dval, lanes["best_slot"].to(torch.int32))
            if out_mode == "dist_ratio":
                base = base + (lanes["hist_c"].to(torch.int32),
                               lanes["uc_c"].to(torch.int32),
                               lanes["v_c"])
            return base + (fetch_over, overflow)
        out = self._scatter_back(lanes, B, onmers)
        return tuple(out) + (onmers, overflow)

    # -------------------------------------------------------------- public
    def suggested_batch_reads(self, place: bool = False) -> int:
        """Reads per device batch keeping the dense per-(read, leaf) stage-2
        state (and the stage-3 per-(read, tree-node) state for place) under
        ~1 GB. Event-mode dist never materialises [B, S] beyond a present
        bitmap, so its batches are bounded by lane capacities instead."""
        if self.mode == "event" and not place:
            return min(32768, max(256, (1 << 30) // (32 * max(self.S, 1))))
        per_read = (256 if place else 128) * max(self.S, 1)
        return max(256, (1 << 30) // per_read)

    def upload(self, codes, lengths, leaf_ok=None):
        """Pack a host batch and place it on the device: (packed, vbits or
        None, lengths int32, leaf_ok bool), the inputs of a step. On the
        card the copies go through pinned memory, non-blocking."""
        dev = self.device
        with trace.span("upload"):
            if leaf_ok is None:
                leaf_ok = np.ones(self.S, bool)
            host = codec.pack_codes_host(np.asarray(codes),
                                         np.asarray(lengths)) + (
                np.asarray(lengths, np.int32), np.asarray(leaf_ok, bool))
            if dev.type == "cuda" and trace.enabled():
                trace.count("h2d_bytes", sum(a.nbytes for a in host
                                             if a is not None))
            return tuple(None if a is None else _upload(a, dev)
                         for a in host)

    def run_step(self, step, codes, lengths, leaf_ok=None) -> _Pending:
        """Upload a batch and enqueue `step(tables, packed, vbits, lengths,
        leaf_ok)` on it (`_full_impl` for dist, a stage-3 step for place);
        returns its pending outputs."""
        return _Pending(step(self._tables, *self.upload(codes, lengths,
                                                        leaf_ok)),
                        self.device)

    def _dispatch(self, codes, lengths, leaf_ok, out_mode: str,
                  exact: bool = False, tier: int = 0,
                  lane_exact: bool = False) -> _Pending:
        return self.run_step(functools.partial(
            self._full_impl, exact=exact, out_mode=out_mode, tier=tier,
            lane_exact=lane_exact), codes, lengths, leaf_ok)

    def run_leaf_stage_async(self, codes: np.ndarray, lengths: np.ndarray,
                             leaf_ok: Optional[np.ndarray] = None,
                             out_mode: str = "full") -> _Pending:
        """Dispatch the step; returns its pending outputs without waiting
        for the host copies, so callers can keep batches in flight."""
        return self._dispatch(codes, lengths, leaf_ok, out_mode)

    def run_tier(self, codes, lengths, leaf_ok, tier: int,
                 out_mode: str = "full", lane_exact: bool = False):
        """Re-run at a larger capacity tier (overflow path); lane_exact
        removes the stage-2 lane cap."""
        return self._dispatch(codes, lengths, leaf_ok, out_mode, tier=tier,
                              lane_exact=lane_exact)

    def run_exact(self, codes, lengths, leaf_ok, out_mode: str = "full"):
        """Exact full-depth scan (heavy-tail overflow fallback)."""
        return self._dispatch(codes, lengths, leaf_ok, out_mode, exact=True)

    def fetch_leaf_stage(self, dev_out: _Pending, lengths: np.ndarray,
                         codes: Optional[np.ndarray] = None,
                         leaf_ok: Optional[np.ndarray] = None,
                         out_mode: str = "full") -> "LeafResults":
        """Wait for a run_leaf_stage_async result and build LeafResults."""
        return self.fetch_prefetched(dev_out.get(), lengths, codes=codes,
                                     leaf_ok=leaf_ok, out_mode=out_mode)

    def fetch_prefetched(self, fetched, lengths: np.ndarray,
                         codes: Optional[np.ndarray] = None,
                         leaf_ok: Optional[np.ndarray] = None,
                         out_mode: str = "full") -> "LeafResults":
        """Build LeafResults from a fetched (host numpy) output tuple,
        re-running overflowed batches: probe overflow -> tiers 1-3, then the
        exact CSR rescan (event mode: RuntimeError, its "exact" is only
        tier 2); lane overflow -> tiers, then uncapped lanes;
        compact-fetch overflow -> the full output set."""
        with trace.span("fetch"):
            return self._fetch(fetched, lengths, codes, leaf_ok, out_mode)

    def _fetch(self, fetched, lengths, codes, leaf_ok, out_mode):
        lane_form = out_mode in ("dist", "dist_ratio")
        ov_flags = int(np.max(fetched[-1]))
        over = ov_flags != 0
        fetch_over = lane_form and bool(fetched[-2])
        if over or fetch_over:
            if codes is None:
                raise ValueError("the overflow fallback needs the batch codes")
            if over:
                for tier in (1, 2, 3):
                    self.escalations += 1
                    fetched = self.run_tier(codes, lengths, leaf_ok,
                                            tier).get()
                    ov_flags = int(np.max(fetched[-1]))
                    if ov_flags == 0:
                        break
                else:
                    self.escalations += 1
                    exhausted = RuntimeError(
                        "event-probe capacity tiers exhausted; the batch is "
                        "pathologically match-dense -- reduce the batch size")
                    if ov_flags & 1:
                        if self.mode == "event":
                            raise exhausted
                        # probe capacity exceeded even at a 64x cap
                        fetched = self.run_exact(codes, lengths,
                                                 leaf_ok).get()
                    else:
                        # probe caps fit, only match lanes overflow: the
                        # uncapped stage 2 is exact
                        fetched = self.run_tier(codes, lengths, leaf_ok, 3,
                                                lane_exact=True).get()
                        if int(np.max(fetched[-1])) & 1:
                            raise exhausted
            else:
                self.escalations += 1
                fetched = self.run_leaf_stage_async(codes, lengths,
                                                    leaf_ok).get()
            out_mode = "full"
        fetched = fetched[:-1]
        if out_mode in ("dist", "dist_ratio"):
            fetched = fetched[:-1]
            if out_mode == "dist_ratio":
                (bits, dval, best_slot, hist_c, uc_c, v_c) = fetched
            else:
                (bits, dval, best_slot) = fetched
                hist_c = uc_c = v_c = None
            # the present bits in read-major, slot-minor order: the order
            # the step compacted dval in
            b, s = codec.set_bits_host(bits, self.S)
            lanes = DistLanes(b, s, dval[:len(b)], self.S)
            rho_c = None
            if out_mode == "dist_ratio":
                rho_c = np.where(best_slot >= 0,
                                 self.di.rho_slot[np.maximum(best_slot, 0)],
                                 0.0)
                hist_c = np.asarray(hist_c, np.float64)
                uc_c = np.asarray(uc_c, np.float64)
            return LeafResults(
                present=None, d=None, closest_slot=best_slot,
                closest_d=lanes.at_slot(best_slot), hist_closest=hist_c,
                uc_closest=uc_c, rho_closest=rho_c, v_closest=v_c,
                onmers=None, lengths=np.asarray(lengths), lanes=lanes)
        (present, hist_f, d_f, v_f, mc_f, uc_f, rho, best_slot, best_d,
         hist_c, uc_c, rho_c, v_c, ratio) = fetched[:-1]
        return LeafResults(
            present=present, hist=hist_f, d=d_f, v=v_f, match=mc_f, uc=uc_f,
            rho=rho, closest_slot=best_slot, closest_d=best_d,
            hist_closest=hist_c, uc_closest=uc_c, rho_closest=rho_c,
            v_closest=v_c, ratio=ratio, onmers=fetched[-1],
            lengths=np.asarray(lengths),
            # a dist batch re-run in full: its lanes too, so its report
            # reads the one form
            lanes=DistLanes.from_dense(present, d_f) if lane_form else None)

    def compute_ratio_host(self, lr: "LeafResults") -> np.ndarray:
        """Chi-square LRT of each of lr's lanes vs its read's closest leaf,
        on the host (ref: src/query.cpp:420-424): f64 [n], in the lanes'
        order; used with out_mode='dist_ratio'."""
        with trace.span("fetch"):
            if not hasattr(self, "_llh_np"):
                self._llh_np = make_llh_np(self.lsh.k, self.lsh.h, self.th)
            b = lr.lanes.b
            return 2.0 * (self._llh_np(lr.lanes.d, lr.hist_closest[b],
                                       lr.uc_closest[b], lr.rho_closest[b])
                          - lr.v_closest[b])


class _RowMap:
    """LSH row -> unified row: urow = (rix // m) * R + rank(rix % m),
    through m-entry (resident, rank) lookup tables on the device."""

    def __init__(self, layout, device):
        self.m = layout.lsh.m
        self.R = layout.R
        self.resident = torch.from_numpy(
            np.asarray(layout.resident, bool)).to(device)
        self.rank = torch.from_numpy(np.where(
            layout.resident, layout.res_rank, 0).astype(np.int64)).to(device)

    def __call__(self, rix, valid):
        """(urow int64, 0 where not resident; resident bool). rix holds u32
        values below 2^30; % and // run widened to int64."""
        r64 = rix.to(torch.int64)
        rmod = r64 % self.m
        resident = self.resident[rmod] & valid
        urow = (r64 // self.m) * self.R + self.rank[rmod]
        return torch.where(resident, urow, 0), resident


def _check_leaf_ranges(di: DeviceIndex) -> None:
    """Every color an entry carries must expand to at least one leaf slot:
    the event probe would otherwise drop its matches, hd included, from
    minall (the reference's silent loss; ROADMAP Queue 3)."""
    cards = np.diff(di.leaf_csr_off)
    empty = np.unique(di.se_v[cards[di.se_v] == 0])
    if len(empty):
        raise ValueError(
            f"{len(empty)} color(s) with an empty leaf-slot range (first: "
            f"{int(empty[0])}); the index's color table is inconsistent")


def _f64_segment_min(dm, keep, seg, NB: int, lb):
    """Segment-min of the kept f64 lanes (native f64 on every device; the
    reference's float-float TPU branch is not needed). Returns (cand [NB],
    D_MAX for empty segments, and the per-lane mask of lanes equal to their
    segment's min)."""
    cand = torch.full((NB,), D_MAX, dtype=F, device=dm.device)
    cand = cand.scatter_reduce(0, seg, torch.where(keep, dm, D_MAX), "amin")
    return cand, keep & (dm == cand[lb])


def _f64_segment_select(x, mask, seg, NB: int):
    """Per segment, the single mask-marked lane of x (callers guarantee at
    most one; segments with none give 0). A sum of one value and zeros,
    so it is exact in any order."""
    sel = torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                      torch.zeros_like(x))
    z = torch.zeros((NB,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return z.index_add(0, seg, sel)


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over one dimension."""
    out = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        out = out | x.select(dim, j)
    return out


def _csr_bucket_slices(row_start, row_ids, urow, resident):
    """(start, cnt) per probe from a dense or sparse-row CSR."""
    if row_ids is None:
        start = row_start[urow]
        cnt = torch.where(resident, row_start[urow + 1] - start, 0)
        return start, cnt
    i = torch.clamp(torch.searchsorted(row_ids, urow),
                    max=row_ids.shape[0] - 1)
    found = resident & (row_ids[i] == urow)
    start = row_start[i]
    cnt = torch.where(found, row_start[i + 1] - start, 0)
    return start, cnt


def _pad_batch(codes: Optional[np.ndarray], lengths: np.ndarray, mult: int):
    """Pad the batch (with zero-length reads) to a multiple of an engine's
    data-parallel width (codes may be None); callers slice results back to
    the real count (`LeafResults.select`)."""
    padn = (-len(lengths)) % mult
    if padn == 0:
        return codes, lengths
    if codes is not None:
        codes = np.concatenate(
            [codes, np.full((padn, codes.shape[1]), 4, codes.dtype)])
    lengths = np.concatenate([lengths, np.zeros(padn, lengths.dtype)])
    return codes, lengths


@dataclass
class DistLanes:
    """dist's host results: one entry per present (read, leaf slot) pair,
    in read-major, slot-minor order (np.flatnonzero's over the [B, S]
    grid)."""

    b: np.ndarray                       # int64 [n] read
    s: np.ndarray                       # int64 [n] leaf slot
    d: np.ndarray                       # f64 [n]
    S: int
    ratio: Optional[np.ndarray] = None  # f64 [n] chisq vs closest, once set

    @classmethod
    def from_dense(cls, present: np.ndarray, d: np.ndarray) -> "DistLanes":
        S = present.shape[1]
        flat = np.flatnonzero(present)
        b, s = np.divmod(flat, S)
        return cls(b, s, d.reshape(-1)[flat], S)

    def at_slot(self, slot: np.ndarray) -> np.ndarray:
        """d at each read's `slot` (int [B]), D_MAX where the slot is -1 or
        holds no lane: the grid's d[arange(B), max(slot, 0)] where
        slot >= 0, by binary search in the lanes' sorted keys."""
        out = np.full(len(slot), D_MAX)
        if len(self.b) == 0:
            return out
        key = self.b * self.S + self.s
        want = np.arange(len(slot)) * self.S + np.maximum(slot, 0)
        i = np.minimum(np.searchsorted(key, want), len(key) - 1)
        hit = (slot >= 0) & (key[i] == want)
        out[hit] = self.d[i[hit]]
        return out

    def select(self, lo: int, hi: int) -> "DistLanes":
        """The lanes of reads [lo, hi), their reads counted from lo."""
        i, j = np.searchsorted(self.b, (lo, hi))
        return DistLanes(self.b[i:j] - lo, self.s[i:j], self.d[i:j], self.S,
                         None if self.ratio is None else self.ratio[i:j])

    def dense(self, name: str, B: int) -> Optional[np.ndarray]:
        """The [B, S] grid of `name` ("present", "d" or "ratio"; None for a
        ratio not yet set), counted as `dense_views`."""
        vals = {"present": True, "d": self.d, "ratio": self.ratio}[name]
        if vals is None:
            return None
        trace.count("dense_views")
        # an absent cell's d = D_MAX makes log(1 - d), so its ratio, NaN
        fill = {"present": False, "d": D_MAX, "ratio": np.nan}[name]
        out = np.full(B * self.S, fill)
        out[self.b * self.S + self.s] = vals
        return out.reshape(B, self.S)


@dataclass
class LeafResults:
    """Strand-resolved per-(read, leaf-slot) match state = node_to_minfo.

    Fields not in the fetched out_mode are None. dist's out modes fetch
    `lanes` and no [B, S] array: `present`, `d` and `ratio` are then built
    from them when first read."""

    present: np.ndarray       # bool [B, S]
    d: np.ndarray             # f64 [B, S] (D_MAX where absent)
    closest_slot: np.ndarray  # int32 [B] (-1 if none)
    closest_d: np.ndarray     # f64 [B]
    hist_closest: np.ndarray  # f64 [B, th+1]
    uc_closest: np.ndarray    # f64 [B]
    rho_closest: np.ndarray   # f64 [B]
    v_closest: np.ndarray     # f64 [B]
    onmers: np.ndarray        # int32 [B]
    lengths: np.ndarray       # int32 [B]
    hist: Optional[np.ndarray] = None    # int32 [B, S, th+1]
    v: Optional[np.ndarray] = None       # f64 [B, S]
    match: Optional[np.ndarray] = None   # int32 [B, S]
    uc: Optional[np.ndarray] = None      # f64 [B, S]
    rho: Optional[np.ndarray] = None     # f64 [B, S]
    ratio: Optional[np.ndarray] = None   # f64 [B, S] chisq vs closest
    lanes: Optional[DistLanes] = None

    def select(self, lo: int, hi: int) -> "LeafResults":
        """Reads [lo, hi): every per-read (leading batch axis) field
        sliced, and the lanes of those reads, counted from lo. It reads the
        stored fields, so a dense view not yet built stays unbuilt."""
        B = len(self.lengths)
        fields = {}
        for name, v in vars(self).items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == B:
                v = v[lo:hi]
            fields[name] = v
        if self.lanes is not None:
            fields["lanes"] = self.lanes.select(lo, hi)
        return type(self)(**fields)


def _dense_view(name: str) -> property:
    """LeafResults.<name>: as stored, or, where that is None and lanes are
    held, their [B, S] grid, built on the first read and kept."""

    def get(self):
        v = self.__dict__[name]
        if v is None and self.lanes is not None:
            v = self.lanes.dense(name, len(self.lengths))
            self.__dict__[name] = v
        return v

    def put(self, v):
        self.__dict__[name] = v

    return property(get, put)


for _name in ("present", "d", "ratio"):
    setattr(LeafResults, _name, _dense_view(_name))
del _name


class SeekEngine:
    """Single-target sketch search (ref: src/seek.cpp) on one device.

    Probe layouts, as the reference's: 'direct' -- a [nrows_u, 1 + C0]
    bucket-row table (count word, then the C0 = max_bucket residuals) when
    the sketch has dense rows and max_bucket <= SEEK_DIRECT_CAP; else
    'csr' -- the entry array + offsets, scanned to the deepest bucket (one
    host sync)."""

    def __init__(self, sketch: DeviceSketch, hdist_th: int = 4,
                 device="cuda"):
        self.device = resolve_device(device)
        self.sk = sketch
        self.th = int(hdist_th)
        self.lsh = sketch.lsh
        self._rows = _RowMap(sketch, self.device)
        slots = self._build_direct_table(sketch)
        if slots is not None:
            self.mode = "direct"
            self._tables = (_i32(slots, self.device),)
        else:
            self.mode = "csr"
            self._tables = (
                _i32(sketch.enc_v, self.device),
                torch.from_numpy(sketch.row_start.astype(np.int64)).to(
                    self.device),
                None if sketch.row_ids is None else torch.from_numpy(
                    sketch.row_ids.astype(np.int64)).to(self.device))

    @staticmethod
    def _build_direct_table(sk: DeviceSketch):
        if sk.row_ids is not None or sk.max_bucket > SEEK_DIRECT_CAP:
            return None
        C0 = max(1, sk.max_bucket)
        if sk.nrows_u * (1 + C0) * 4 > DIRECT_MEM_CAP:
            return None
        counts = np.diff(sk.row_start)
        urow_of = np.repeat(np.arange(sk.nrows_u, dtype=np.int64), counts)
        j = (np.arange(len(sk.enc_v), dtype=np.int64)
             - np.repeat(sk.row_start[:-1], counts))
        slots = np.zeros((sk.nrows_u, 1 + C0), np.uint32)
        slots[:, 0] = counts.astype(np.uint32)
        slots[urow_of, 1 + j] = sk.enc_v
        return slots

    def _strand_min(self, rix, res, valid):
        """Per-probe minimum Hamming distance, HD_SENTINEL above th."""
        urow, resident = self._rows(rix, valid)
        if self.mode == "direct":
            (slots,) = self._tables
            ent = slots[urow]                            # [B, P, 1 + C0]
            hd = codec.hdist_lr32(ent[..., 1:], res[..., None])
            j = torch.arange(hd.shape[-1], dtype=torch.int32,
                             device=hd.device)
            match = (resident[..., None] & (j < ent[..., :1])
                     & (hd <= self.th))
            gmin = torch.where(match, hd, HD_SENTINEL).amin(dim=-1)
            return torch.where(gmin <= self.th, gmin, HD_SENTINEL)
        enc_v, row_start, row_ids = self._tables
        start, cnt = _csr_bucket_slices(row_start, row_ids, urow, resident)
        return scan_buckets_min(enc_v, start, cnt, res, self.th,
                                self.sk.max_bucket)

    def _run_impl(self, packed, vbits, lengths):
        """(has [B] bool, d [B] f64): the better strand's ML distance."""
        codes = codec.unpack_codes(packed, lengths, packed.shape[1] * 16,
                                   vbits)
        dev = codes.device
        k = self.lsh.k
        B, L = codes.shape
        rix_or, rix_rc, res_or, res_rc, valid_w = codec.strand_hashes(
            codes, self.lsh)
        t_idx = torch.arange(L - k + 1, dtype=torch.int32, device=dev)
        valid = valid_w & (t_idx[None, :] <= lengths[:, None] - k)
        onmers = valid.sum(dim=1).to(F)
        xs = torch.arange(self.th + 1, dtype=torch.int32, device=dev)
        rho = torch.full((B,), self.sk.rho, dtype=F, device=dev)
        outs = []
        for rix, res in ((rix_or, res_or), (rix_rc, res_rc)):
            gmin = self._strand_min(rix, res, valid)
            hist = (gmin[..., None] == xs).sum(dim=1)    # [B, th+1]
            matchc = hist.sum(dim=-1).to(F)
            bx = (hist * xs).sum(dim=-1).to(F)
            d, _ = brent_llh(matchc, bx, onmers - matchc, rho, None, k,
                             self.lsh.h, self.th)
            outs.append((matchc, d))
        (mc_or, d_or), (mc_rc, d_rc) = outs
        return (mc_or + mc_rc) > 0, torch.where(d_or < d_rc, d_or, d_rc)

    def run(self, codes: np.ndarray, lengths: np.ndarray):
        """One batch -> (has, d) as host numpy arrays."""
        dev = self.device
        packed, vbits = codec.pack_codes_host(np.asarray(codes),
                                              np.asarray(lengths))
        has, d = self._run_impl(
            _upload(packed, dev), None if vbits is None
            else _upload(vbits, dev), _upload(np.asarray(lengths, np.int32),
                                              dev))
        return has.cpu().numpy(), d.cpu().numpy()
