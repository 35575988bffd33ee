"""Sharded querying: the index row-sharded over devices, reads over data rows.

Port of krepp_tpu/parallel/mesh.py. A [n_data, n_shard] mesh of devices
holds the flat CSR cut into contiguous content-row blocks balanced by
ENTRY count (not row count), one block a shard; every probe's bucket lives
on one shard, so the shards' per-(read, leaf) first-match histograms sum
exactly. A data row takes its slice of every read batch. Each shard
carries the single-device engine's hybrid bucket-row table with the CSR
tail (no heavy table, as the reference), so its probe launches the same
epilogue kernels (`probe_hist_packed` / `probe_hist_tiles`) on the
shard's device; CSR mode and the event lanes shard the same way. Sparse
row spaces (h >= 13) keep their nonempty-row ids per shard and route by a
shard-local binary search.

Where the reference runs one SPMD program under `shard_map`, the port runs
the per-shard step of every cell it owns at the same time, one host thread
a cell under `torch.cuda.device(cell's card)`, so that a cell's host sync
waits for its own card only. The threads take turns at the host
(core/host_turn.py): a step launches its ops holding the engine's turn and
gives it up while it waits for its card, so the cards run at once while
one cell's ops are launched at a time (threads that launch ops together hand
the interpreter lock over at every op, at many times the op's cost). Then
the calling thread merges the partials, in cell order, through two
collectives:

  * `_reduce` over a data row's shards: `sum` of the int32 histograms,
    `min` of minall, `max` of the overflow flag (on the process's lead
    device), or the concatenation of event lanes (on the row's first
    card, where a thread a row then joins them and runs stage 2, with lane
    keys offset to the batch: the reference's event-lane pipeline, which
    runs each row's stage 2 on that row's devices);
  * `_gather_rows` over data rows: the rows' probe outputs (or stage-2
    lanes) concatenated into the whole batch's on the lead device.

No collective is called from a worker thread, so every process of a group
calls the same ones in the same order. Stage 2 and everything after it
are otherwise the single-device engine's, on the whole batch. In one
process both collectives are copies and a stack or concatenation;
parallel/multihost.py overrides them with torch.distributed. Results equal
the single-device engine's: integers element for element, distances
because stage 2 sees the same lanes in the same order. `concurrent=False`
runs the cells one after the other on the calling thread instead (the
pair a measurement compares; nothing else selects it).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import trace
from ..core.host_turn import host_turn
from ..index.index import DeviceIndex
from ..query import engine as qengine
from ..query.bucket_scan import probe_strand, probe_strand_full
from ..query.event_probe import event_probe_lanes
from ..query.engine import (DENSE_SLOTS, QueryEngine, _check_leaf_ranges,
                            _i32, _pad_batch, _RowMap, build_hybrid_slots,
                            hybrid_flavor)
from .build import mesh_devices

# routing bound of shards past the last content row (int64: any row id of
# any row space lies below it)
ROW_SENTINEL = np.iinfo(np.int64).max
# the stage-2 lane fields a data row hands over, in order
LANE_KEYS = ("idx", "lv", "present_l", "hist_f", "d_f", "v_f", "mc_f", "uc_f",
             "rho_l", "best_slot", "best_d", "hist_c", "uc_c", "rho_c", "v_c")


class QueryMesh:
    """A [n_data, n_shard] grid of torch devices. devices[g][s] is data row
    g's shard s, or None where another process owns the cell (then
    ranks[g][s] names it); `rank` is this process's."""

    def __init__(self, devices, ranks=None, rank: int = 0):
        self.devices = devices
        self.n_data = len(devices)
        self.n_shard = len(devices[0])
        self.ranks = ranks or [[0] * self.n_shard] * self.n_data
        self.rank = rank

    def own(self):
        """(g, s, device) of this process's cells, row-major."""
        return [(g, s, d) for g, row in enumerate(self.devices)
                for s, d in enumerate(row) if d is not None]


def parse_mesh(spec: str):
    """'DATAxSHARD' -> (n_data, n_shard); SystemExit on anything else."""
    parts = str(spec).lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise SystemExit(f"--mesh {spec}: expected DATAxSHARD, two positive "
                         "integers (e.g. 2x4)")
    return int(parts[0]), int(parts[1])


def make_query_mesh(n_data: int, n_shard: int, devices=None,
                    device="cuda") -> QueryMesh:
    """The first n_data * n_shard devices (default: `mesh_devices` of kind
    `device`: distinct cards, fewer raise naming the count; the host
    repeated for "cpu") laid out row-major as [n_data, n_shard]."""
    n = n_data * n_shard
    if n_data < 1 or n_shard < 1:
        raise ValueError(f"--mesh {n_data}x{n_shard}: both sides must be "
                         "positive")
    if devices is None:
        devices = mesh_devices(n, device, what=f"--mesh {n_data}x{n_shard}")
    devices = [resolve_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"--mesh {n_data}x{n_shard} needs {n} devices, "
                         f"got {len(devices)}")
    return QueryMesh([devices[g * n_shard: (g + 1) * n_shard]
                      for g in range(n_data)])


def _taking_turns(step):
    """A cell step that launches its ops holding its engine's host turn."""
    @functools.wraps(step)
    def run(self, *args):
        with self._host_turn():
            return step(self, *args)
    return run


class ShardedQueryEngine(QueryEngine):
    """QueryEngine whose stage-1 probe runs per shard on a device mesh.

    Index rows are block-sharded over the mesh's shard axis (blocks
    balanced by entry count), reads over its data rows; each owned cell's
    step runs on its own host thread (concurrent=True), or in turn on the
    calling thread (concurrent=False). Stage 2 runs on the merged probe
    outputs of the whole batch on the lead device (this process's first
    cell), except in event mode, where each data row's runs on its first
    card over the row's event lanes."""

    def __init__(self, dindex: DeviceIndex, mesh: QueryMesh,
                 hdist_th: int = 4, concurrent: bool = True):
        self.mesh = mesh
        self.n_shard = mesh.n_shard
        self.n_data = mesh.n_data
        self.concurrent = concurrent
        own = mesh.own()
        if not own:
            raise ValueError("this process owns no cell of the mesh")
        # a thread a cell, kept for the engine's life: its threads start at
        # the first step and end when the engine is collected; they take
        # turns at the host (core/host_turn.py)
        self._pool = (ThreadPoolExecutor(len(own), "krepp-mesh-cell")
                      if concurrent else None)
        self._turn = threading.Lock()
        super().__init__(dindex, hdist_th, device=own[0][2])

    # --------------------------------------------------------- table builds
    def _init_tables(self, di: DeviceIndex) -> None:
        """Per-shard tables on each cell's device; the leaf-bitmask table
        (or, in event mode, the leaf-slot CSR) replicated on each."""
        self._tables = ()
        self._rowmaps: Dict[torch.device, _RowMap] = {self.device: self._rows}
        if di.se_mask is None or qengine.FORCE_EVENT:
            _check_leaf_ranges(di)
            blocks = self._build_shards(di, force_flavor="se")
            if self.mode != "hybrid":
                raise RuntimeError(
                    "the event probe's bucket-row table of one shard exceeds "
                    f"DIRECT_MEM_CAP ({qengine.DIRECT_MEM_CAP} bytes); use "
                    f"more shards than {self.n_shard}")
            self.mode = "event"
            replicated = dict(leaf_off=di.leaf_csr_off.astype(np.int64),
                              leaf_slots=di.leaf_csr_slots.astype(np.int32))
        else:
            blocks = self._build_shards(di)
            replicated = dict(mask=di.se_mask)
        placed = {}
        self._cells = {}
        for g, s, dev in self.mesh.own():
            if (s, dev) not in placed:
                t = {k: None if a is None else _i32(a, dev)
                     for k, a in {**blocks[s], **replicated}.items()}
                t.update(dev=dev, bounds=self._bounds[s])
                placed[s, dev] = t
            self._cells[g, s] = placed[s, dev]
            # built here, not at first use: the cells' threads only read
            if dev not in self._rowmaps:
                self._rowmaps[dev] = _RowMap(di, dev)

    def _build_shards(self, di: DeviceIndex,
                      force_flavor: Optional[str] = None):
        """Cut the CSR into n_shard entry-balanced content-row blocks; sets
        the mode ('hybrid' with a bucket-row table, else 'csr'), flavor,
        C0 and the routing bounds. Returns {shard: numpy arrays} for the
        shards this process owns, each padded to the largest block."""
        D = self.n_shard
        W = self.W
        self._dense_space = di.row_ids is None
        starts = di.row_start.astype(np.int64)
        ncontent = len(starts) - 1
        total = int(starts[-1])
        targets = (np.arange(1, D, dtype=np.int64) * total) // max(D, 1)
        cuts = np.searchsorted(starts, targets, side="left")
        bnd = np.maximum.accumulate(
            np.concatenate([[0], cuts, [ncontent]]).astype(np.int64))
        self._row_bounds = bnd
        # unified-row routing bounds per shard
        if self._dense_space:
            ulo = bnd.copy()
            ulo[-1] = di.nrows_u
        else:
            ulo = np.zeros(D + 1, np.int64)
            for s in range(1, D):
                ulo[s] = (di.row_ids[bnd[s]] if bnd[s] < ncontent
                          else ROW_SENTINEL)
            ulo[-1] = ROW_SENTINEL
        self._bounds = [(int(ulo[s]), int(ulo[s + 1])) for s in range(D)]

        maxrows = max(1, int(np.max(bnd[1:] - bnd[:-1])))
        maxlen = max(1, int(np.max(starts[bnd[1:]] - starts[bnd[:-1]])))
        self.C0 = min(DENSE_SLOTS, max(1, di.max_bucket))
        flavor = force_flavor or hybrid_flavor(maxrows + 1, di.max_bucket, W)
        nsrows = maxrows if self._dense_space else maxrows + 1
        self._zero_row = nsrows - 1          # all-zero on every shard
        self.mode = "csr" if flavor is None else "hybrid"
        self.hflavor = flavor
        blocks = {}
        for s in sorted({s for _, s, _ in self.mesh.own()}):
            lo, hi = int(bnd[s]), int(bnd[s + 1])
            b, e = int(starts[lo]), int(starts[hi])
            enc_se = np.zeros((maxlen, 2), np.uint32)
            enc_se[: e - b, 0] = di.enc_v[b:e]
            enc_se[: e - b, 1] = di.se_v[b:e].astype(np.uint32)
            seg = starts[lo: hi + 1] - b
            row = np.zeros(maxrows + 1, np.int64)
            row[: hi - lo + 1] = seg
            row[hi - lo + 1:] = seg[-1]
            rid = None
            if not self._dense_space:
                rid = np.full(maxrows, ROW_SENTINEL, np.int64)
                rid[: hi - lo] = di.row_ids[lo:hi]
            slots = None
            if flavor is not None:
                blk, _ = build_hybrid_slots(
                    seg, di.enc_v[b:e], di.se_v[b:e], di.se_mask,
                    (hi - lo) if self._dense_space else None,
                    max(1, di.max_bucket), W, flavor=flavor)
                if blk is None:
                    self.mode, self.hflavor = "csr", None
                else:
                    slots = np.zeros((nsrows, blk.shape[1]), np.uint32)
                    slots[: blk.shape[0]] = blk
            blocks[s] = dict(enc_se=enc_se, row_start=row, row_ids=rid,
                             slots=slots)
        return blocks

    def _rowmap(self, dev) -> _RowMap:
        return self._rowmaps[dev]

    # ----------------------------------------------------------- cell threads
    def _host_turn(self):
        """The block holds this engine's host turn (cells at once), or
        nothing (in turn: one thread)."""
        return (host_turn(self._turn) if self.concurrent
                else contextlib.nullcontext())

    def _run(self, jobs: Sequence[Tuple[str, torch.device, Callable]]):
        """Run each job (label, device, fn) under its device: each on a
        host thread of its own, all at once, or with concurrent=False one
        after the other on this thread. Returns the results in job order
        once every job has ended; the first failed job's exception (in job
        order) is then raised here, with a note naming its label. A job's
        spans belong to this thread's current batch (core/trace.py)."""
        bid = trace.current_batch()

        def call(job):
            label, dev, fn = job
            try:
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()), trace.batch(bid):
                    return fn()
            except Exception as exc:
                exc.add_note(f"in {label}")
                raise

        if not self.concurrent:
            return [call(job) for job in jobs]
        futs = [self._pool.submit(call, job) for job in jobs]
        wait(futs)
        return [fut.result() for fut in futs]

    def _run_cells(self, B: int, step):
        """step(t, row slice) on every owned cell (`_run`) -> {data row:
        [its cells' results in shard order]}, rows ascending."""
        jobs, rows = [], []
        for g, cells in self._row_cells().items():
            sl = self._row_slice(B, g)
            for s, t in cells:
                jobs.append((f"mesh cell (data row {g}, shard {s}) on "
                             f"{t['dev']}", t["dev"],
                             lambda t=t, sl=sl: step(t, sl)))
                rows.append(g)
        out: Dict[int, List] = {}
        for g, res in zip(rows, self._run(jobs)):
            out.setdefault(g, []).append(res)
        return out

    # ------------------------------------------------------- sharded probe
    def _shard_route(self, urow, resident, t):
        """Shard-local routing: urow -> (mine, sidx, hrow). Dense row
        spaces translate urow to the block's local row; sparse ones
        binary-search the shard's row ids, misses going to the trailing
        all-zero slots row."""
        ulo, uhi = t["bounds"]
        mine = resident & (urow >= ulo) & (urow < uhi)
        if self._dense_space:
            lrow = torch.where(mine, urow - ulo, 0)
            return mine, lrow, lrow
        rowids = t["row_ids"]
        posc = torch.clamp(torch.searchsorted(rowids, urow),
                           max=rowids.shape[0] - 1)
        found = mine & (rowids[posc] == urow)
        return found, torch.where(found, posc, self._zero_row), posc

    def _shard_hashes(self, t, codes, lengths):
        """Strand hashes of a data row's reads on a shard's device, routed
        to the shard: (res2, mine, sidx, hrow, onmers)."""
        dev = t["dev"]
        with trace.span("hash"):
            rix2, res2, valid, onmers = self._strand_hashes(codes.to(dev),
                                                            lengths.to(dev))
            urow, resident = self._rowmap(dev)(rix2, valid[None])
            mine, sidx, hrow = self._shard_route(urow, resident, t)
        return res2, mine, sidx, hrow, onmers

    @_taking_turns
    def _shard_probe(self, t, codes, lengths, exact: bool, tier: int):
        """One shard's partial probe of a data row: (hist [2, B, S, X],
        minall [2, B], onmers [B], overflow int32 [1]) on its device."""
        res2, mine, sidx, hrow, onmers = self._shard_hashes(t, codes,
                                                            lengths)
        with trace.span("probe"):
            return self._shard_probe_body(t, res2, mine, sidx, hrow, onmers,
                                          exact, tier)

    def _shard_probe_body(self, t, res2, mine, sidx, hrow, onmers,
                          exact: bool, tier: int):
        th, S, W = self.th, self.S, self.W
        mb = self.di.max_bucket
        _, B, P = sidx.shape
        if self.mode == "hybrid" and not exact:
            # no heavy table: the CSR tail, as the reference's shards
            hist, minall, ov = self._hybrid_core(
                t["slots"], t["enc_se"], t["row_start"], t["mask"], sidx,
                hrow, mine, res2, mb, tier)
        else:
            row_start = t["row_start"]
            start = row_start[hrow]
            cnt = torch.where(mine, row_start[hrow + 1] - start, 0)
            if exact:
                hist, minall = probe_strand_full(
                    t["enc_se"], t["mask"], self._expand,
                    start.reshape(2 * B, P), cnt.reshape(2 * B, P),
                    res2.reshape(2 * B, P), th, W, S, mb)
                ov = torch.zeros((), dtype=torch.bool, device=t["dev"])
            else:
                outs = [probe_strand(t["enc_se"], t["mask"], self._expand,
                                     start[st], cnt[st], res2[st], th, W, S,
                                     mb) for st in range(2)]
                hist = torch.cat([o[0] for o in outs])
                minall = torch.cat([o[1] for o in outs])
                ov = outs[0][2] | outs[1][2]
        return (hist.reshape(2, B, S, th + 1), minall.reshape(2, B), onmers,
                ov.to(torch.int32).reshape(1))

    def _row_cells(self):
        """{data row: [(shard, cell table) in shard order]} of this
        process."""
        rows: Dict[int, List] = {}
        for g, s, _ in self.mesh.own():
            rows.setdefault(g, []).append((s, self._cells[g, s]))
        return rows

    def _row_slice(self, B: int, g: int) -> slice:
        if B % self.n_data:
            raise ValueError(f"a batch of {B} reads does not split over "
                             f"{self.n_data} data rows; pad it (_pad_batch)")
        Bl = B // self.n_data
        return slice(g * Bl, (g + 1) * Bl)

    def _probe_impl(self, tables, codes, lengths, exact: bool = False,
                    tier: int = 0):
        """(hist_or, hist_rc, minall_or, minall_rc, onmers, overflow) of the
        whole batch on the lead device: each data row's shard partials
        merged exactly (a probe's bucket lives on one shard)."""
        del tables                      # the shards' own tables are used
        partials = self._run_cells(codes.shape[0], lambda t, sl: (
            self._shard_probe(t, codes[sl], lengths[sl], exact, tier)))
        rows = {}
        with trace.span("probe"):
            for g, parts in partials.items():
                hist = self._reduce(g, [p[0] for p in parts], "sum")
                minall = self._reduce(g, [p[1] for p in parts], "min")
                ov = self._reduce(g, [p[3] for p in parts], "max")
                rows[g] = (hist[0], hist[1], minall[0], minall[1],
                           parts[0][2].to(self.device), ov)
            hist_or, hist_rc, min_or, min_rc, onmers, ov = self._gather_rows(
                rows)
        return hist_or, hist_rc, min_or, min_rc, onmers, ov.amax() > 0

    # ---------------------------------------------- sharded event lanes
    def _shard_resident_cap(self, Np: int, tier: int) -> int:
        """A shard's resident-lane compaction capacity: its share of the
        resident lanes (blocks are entry-balanced) with a 1.3x + 8k margin,
        4x per tier, so a batch that overflows tier 0 recovers at a later
        tier (the reference keeps one cap at every tier; ROADMAP Queue 3)."""
        share = int(Np * self._res_frac() * 1.3 / max(self.n_shard, 1))
        return min(Np, (share + 8192) << (2 * tier))

    def _probe_and_lanes(self, tables, codes, lengths, leaf_ok,
                         lane_cap: Optional[int], exact: bool, tier: int):
        """Event lanes across shards: each shard's lanes are gathered over
        its data row, joined and run through stage 2 per data row (no
        [B, S] array anywhere); lane keys then move to the batch's read
        space. Other modes: the dense path through `_probe_impl`."""
        if self.mode != "event":
            return super()._probe_and_lanes(tables, codes, lengths, leaf_ok,
                                            lane_cap, exact, tier)
        B = codes.shape[0]
        S = self.S
        nd = self.n_data
        Bl = B // nd
        Kl = (Bl * S if lane_cap is None
              else min(Bl * S, max(lane_cap // nd, 4096)))
        etier = max(tier, 2) if exact else tier
        partials = self._run_cells(B, lambda t, sl: self._shard_lanes(
            t, codes[sl], lengths[sl], etier))
        # each row's partials merged on the row's first card, in cell order
        merged = {}
        with trace.span("lanes"):
            for g, parts in partials.items():
                dev = parts[0][0].device
                merged[g] = (dev,) + tuple(
                    self._reduce(g, [p[i] for p in parts], op, dev)
                    for i, op in enumerate(("cat", "cat", "cat", "min",
                                            "max")))

        def row_stage2(g, dev, nb, leaf, hist, minall, ov):
            with self._host_turn():
                with trace.span("lanes"):
                    idx, lv, h_or, h_rc, lane_over = self._event_lane_join(
                        nb, leaf, hist, Kl, Bl)
                onmers = partials[g][0][5]
                L = self._stage2_core(idx, lv, h_or, h_rc, minall[:Bl],
                                      minall[Bl:], onmers, leaf_ok.to(dev),
                                      lane_over)
                # group g owns reads [g*Bl, (g+1)*Bl): its lanes stay
                # ascending
                L["idx"] = torch.where(L["lv"], L["idx"] + g * Bl * S,
                                       nd * Bl * S).to(torch.int32)
                return tuple(L[k] for k in LANE_KEYS) + (
                    onmers, L["lane_over"].to(torch.int32).reshape(1), ov)

        lanes = self._run([(f"stage 2 of data row {g} on {m[0]}", m[0],
                            lambda g=g, m=m: row_stage2(g, *m))
                           for g, m in merged.items()])
        with trace.span("lanes"):
            rows = {g: tuple(x.to(self.device) for x in out)
                    for g, out in zip(merged, lanes)}
            out = self._gather_rows(rows)
            L = dict(zip(LANE_KEYS, out))
            safe = torch.clamp(L["idx"], max=B * S - 1).to(torch.int64)
            L["lb"] = safe // S
            L["ls"] = safe - L["lb"] * S
            L["lane_over"] = out[-2].amax() > 0
        return L, out[-3], out[-1].amax() > 0

    @_taking_turns
    def _shard_lanes(self, t, codes, lengths, etier: int):
        """One shard's event lanes of a data row: (nb_lane, leaf_lane,
        hist_lanes, minall [2B], overflow int32 [1], onmers)."""
        res2, mine, sidx, hrow, onmers = self._shard_hashes(t, codes,
                                                            lengths)
        _, Bl, P = sidx.shape
        E, KH, CAP_L = self._event_caps(Bl, P, etier)
        with trace.span("probe"):
            nb, leaf, hist, minall, ov = event_probe_lanes(
                t["slots"], t["enc_se"], t["row_start"], t["leaf_off"],
                t["leaf_slots"], sidx, hrow, mine, res2, self.th, self.C0,
                self.S, self.di.max_bucket, E, KH, CAP_L, heavy_tab=None,
                KR=self._shard_resident_cap(2 * Bl * P, etier))
        return nb, leaf, hist, minall, ov.to(torch.int32).reshape(1), onmers

    # --------------------------------------------------------- collectives
    def _reduce(self, g: int, parts, op: str, dev=None):
        """Merge one data row's shard partials on `dev` (default: the lead
        device): "sum", "min", "max" (elementwise) or "cat" (in shard
        order)."""
        x = [p.to(self.device if dev is None else dev) for p in parts]
        if op == "cat":
            y = torch.cat(x)
        elif op == "sum":
            y = torch.stack(x).sum(0, dtype=x[0].dtype)
        else:
            y = getattr(torch.stack(x), "a" + op)(0)
        return self._reduce_across(g, y, op)

    def _reduce_across(self, g: int, x, op: str):
        """The same merge with the row's cells of other processes (none in
        one process); the result on x's device."""
        return x

    def _gather_rows(self, rows):
        """{data row: tuple of tensors} -> each field concatenated over
        the data rows, on the lead device."""
        n = len(next(iter(rows.values())))
        return tuple(torch.cat([rows[g][i] for g in sorted(rows)])
                     for i in range(n))

    # --------------------------------------------- data-axis padding
    def _dispatch(self, codes, lengths, leaf_ok, out_mode: str,
                  exact: bool = False, tier: int = 0,
                  lane_exact: bool = False):
        codes, lengths = _pad_batch(np.asarray(codes), np.asarray(lengths),
                                    self.n_data)
        return super()._dispatch(codes, lengths, leaf_ok, out_mode, exact,
                                 tier, lane_exact)

    def fetch_prefetched(self, fetched, lengths: np.ndarray,
                         codes: Optional[np.ndarray] = None,
                         leaf_ok: Optional[np.ndarray] = None,
                         out_mode: str = "full"):
        """The base fetch over the padded batch, sliced back to the
        caller's reads."""
        B = len(lengths)
        codes, lengths = _pad_batch(codes, np.asarray(lengths), self.n_data)
        lr = super().fetch_prefetched(fetched, lengths, codes=codes,
                                      leaf_ok=leaf_ok, out_mode=out_mode)
        return lr if len(lr.lengths) == B else lr.select(0, B)
