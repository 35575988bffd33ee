"""`place`: phylogenetic placement with jplace/tabular/summarize output.

Port of krepp_tpu/query/place.py (IBatch::place_sequences /
report_placement, ref: src/query.cpp:198-333) over the torch engine. Stage 3
turns each read's leaf-level match state into per-placement-node stats and
re-optimises the distance of candidate internal nodes with the batched
Brent solver. Two formulations, chosen by the size of the [Q+1, S] weight
grid (Q placement-tree nodes, S leaf slots), as the reference's:

  * dense (`_place_dense`): damping-weight einsums over [B, Q+1, S], for
    (Q+1)*S <= DENSE_AGG_MAX;
  * lanes (`_place_impl`): each present (read, leaf) lane expands to its
    ancestor events, which sort by (read, node) and segment-reduce into
    node lanes; cost scales with matches * tree depth, not with S.

Everything runs in f64: the reference's f32 MXU halves (`_w_einsum`) and
f32 support counts were TPU workarounds, and no contraction here may drop
to TF32 on the card. The host half (chi-square of the compacted candidates,
LWR normalisation, row emission) is the reference's, with the bulk jplace
emitter of csrc/report.c (built by the port's own loader,
io/native_report.py) guarded against fields it cannot hold.
"""

from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, TextIO

import numpy as np
import torch

from ..reports import (begin_jplace, end_jplace, fmt5, fmt5_array,
                       place_header)

from ..core import codec, trace
from ..core.compact import compact_mask_indices
from ..core.llh import F, brent_llh, make_llh_np
from ..index.index import DeviceIndex, PlacementView
from ..io import native_report
from ..io.fastx import QueryBatcher
from .dist import IN_FLIGHT, _bucket_len, note_batch
from .engine import D_MAX, LeafResults, QueryEngine, _pad_batch

# Stage-3 formulation threshold: dense damping-weight einsums while the
# [Q+1, S] weight grid stays under this many cells; larger worlds take the
# lane path. Tests set it to 0 to force the lane path on small trees.
DENSE_AGG_MAX = 1 << 16
# elements of the largest [reads, Q+1, S] temporary of the dense rho max
RHO_ELEMS = 1 << 25
# csrc/report.c renders each field with an unchecked "%.5f" into 192 bytes
# per row: a finite field at or above this magnitude may overrun it
NATIVE_FIELD_MAX = 1e20


@dataclass
class PlaceConfig:
    hdist_th: int = 4
    chisq_value: float = 2.706
    tau: int = 2
    multi: bool = True
    no_filter: bool = False
    summarize: bool = False
    tabular: bool = False
    batch_bp: int = 16384 * 150
    # multi-process output slicing, as DistConfig.emit_slice
    emit_slice: Optional[tuple] = None


class PlaceAggregator:
    """Stage 3: leaf minfos -> per-placement-node stats (see the module
    docstring for the two formulations; `aggregate` is the dense form over
    a fetched LeafResults)."""

    def __init__(self, engine: QueryEngine, pv: PlacementView,
                 cfg: PlaceConfig):
        self.engine = engine
        self.pv = pv
        self.cfg = cfg
        self.Q = pv.qflat.nnodes
        dev = engine.device
        S = engine.S

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        leaf_of_q = np.full(self.Q + 1, -1, np.int64)    # slot owning leaf q
        for s, q in enumerate(pv.leaf_qse):
            if q > 0:
                leaf_of_q[q] = s
        self._lq = t(np.maximum(leaf_of_q, 0))
        self._is_leaf_q = t(leaf_of_q >= 0)
        self._rho_slot = engine._rho_slot
        self._llh = engine._llh
        # structural candidate gate: eff_nchildren-covered internal nodes
        # with a parent (ref: src/query.cpp:268-281)
        self._cand_struct = t(pv.candidate_ok & (pv.qflat.parent != 0))
        # per-slot ancestor chains for the lane path, leaf first (j = 0 is
        # the slot's own placement-tree leaf): the non-zeros of the weight
        # grid, so the lane path never builds the [Q+1, S] grid
        self._Dmax = pv.anc_q.shape[1]
        self._anc_q = t(pv.anc_q)
        self._anc_w = t(pv.anc_w)
        is_owner = np.zeros(S, bool)
        for s, q in enumerate(pv.leaf_qse):
            if q > 0 and leaf_of_q[q] == s:
                is_owner[s] = True
        self._is_owner = t(is_owner)
        self._rho_of_q = t(np.where(
            leaf_of_q >= 0,
            np.asarray(engine.di.rho_slot)[np.maximum(leaf_of_q, 0)], 0.0))
        self.dense = (self.Q + 1) * S <= DENSE_AGG_MAX
        self._llh_np = make_llh_np(engine.lsh.k, engine.lsh.h, engine.th)

    @functools.cached_property
    def _W(self) -> torch.Tensor:
        """[Q+1, S] f64 damping weights on the device: the dense
        formulation's (and `aggregate`'s), built at first use."""
        return torch.from_numpy(self.pv.weights).to(self.engine.device)

    @functools.cached_property
    def _Wpos(self) -> torch.Tensor:
        return self._W > 0

    # ------------------------------------------------- dense aggregation
    def _rho_max(self, present):
        """max over slots s of where(W[q, s] > 0 & present[b, s],
        rho_slot[s], 0) -> [B, Q+1], in read chunks that keep the
        [reads, Q+1, S] temporary under RHO_ELEMS elements."""
        B, S = present.shape
        Qp = self.Q + 1
        out = torch.empty((B, Qp), dtype=F, device=present.device)
        rows = max(1, RHO_ELEMS // (Qp * S))
        for lo in range(0, B, rows):
            m = self._Wpos[None, :, :] & present[lo: lo + rows, None, :]
            out[lo: lo + rows] = torch.where(
                m, self._rho_slot[None, None, :], 0.0).amax(dim=2)
        return out

    def _dense_ancestors(self, present, hist, match):
        """The ancestor walk (ref: src/query.cpp:248-265) as damping-weight
        contractions: (histW [B, Q+1, X], matchW [B, Q+1], support
        [B, Q+1] bool, rhoW [B, Q+1]). f64 throughout; the support counts
        (<= S) are exact in f64."""
        p = present.to(F)
        histW = torch.einsum("qs,bsx->bqx", self._W,
                             hist.to(F) * p[..., None])
        matchW = torch.einsum("qs,bs->bq", self._W, match.to(F) * p)
        support = (p @ self._Wpos.to(F).T) > 0
        return histW, matchW, support, self._rho_max(present)

    def _agg_impl(self, present, hist, match, d, v, uc, onmers, lengths,
                  hist_c, uc_c, rho_c, v_c):
        """Returns per-(read, qnode): hist_q, uc_q, rho_q, d_q, v_q,
        support_q, leq_tau_q, chisq_q."""
        with trace.span("stage3"):
            return self._agg_body(present, hist, match, d, v, uc, onmers,
                                  lengths, hist_c, uc_c, rho_c, v_c)

    def _agg_body(self, present, hist, match, d, v, uc, onmers, lengths,
                  hist_c, uc_c, rho_c, v_c):
        k = self.engine.lsh.k
        histW, matchW, support, rhoW = self._dense_ancestors(present, hist,
                                                             match)
        enmers = (lengths - k + 1).to(F)
        uc_int = enmers[:, None] - matchW                    # internal nodes

        # leaf nodes use their own strand-resolved minfo verbatim
        lq = self._lq
        isl = self._is_leaf_q[None, :]
        hist_q = torch.where(isl[..., None], hist[:, lq, :].to(F), histW)
        uc_q = torch.where(isl, uc[:, lq], uc_int)
        rho_q = torch.where(isl, self._rho_slot[lq][None, :], rhoW)

        # re-optimise supported internal nodes (ref: src/query.cpp:272-275)
        xs = torch.arange(hist_q.shape[-1], dtype=F, device=hist_q.device)
        d_opt, v_opt = brent_llh(hist_q.sum(dim=-1), (hist_q * xs).sum(dim=-1),
                                 uc_q, rho_q, support & ~isl, k,
                                 self.engine.lsh.h, self.engine.th)
        d_q = torch.where(isl, d[:, lq], d_opt)
        v_q = torch.where(isl, v[:, lq], v_opt)
        leq_tau = hist_q[..., : self.cfg.tau + 1].sum(dim=-1)
        chisq_q = 2.0 * (self._llh(d_q, hist_c[:, None, :], uc_c[:, None],
                                   rho_c[:, None]) - v_c[:, None])
        return hist_q, uc_q, rho_q, d_q, v_q, support, leq_tau, chisq_q

    def aggregate(self, lr: LeafResults):
        """_agg_impl over a full-out_mode LeafResults (host arrays)."""
        dev = self.engine.device

        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)

        out = self._agg_impl(
            t(lr.present), t(lr.hist), t(lr.match), t(lr.d), t(lr.v),
            t(lr.uc), t(lr.onmers), t(lr.lengths), t(lr.hist_closest),
            t(lr.uc_closest), t(lr.rho_closest), t(lr.v_closest))
        return tuple(o.cpu().numpy() for o in out)

    # --------------------------------------------------- fused steps
    def _candidates(self, pre_cand, B: int, tier: int):
        """Compact the candidate node lanes to Kc slots: (csafe, the
        clamped int64 indices [Kc]; n_cand; n_cand > Kc)."""
        M = pre_cand.shape[0]
        Kc = min(M, max(4096, 8 * B) << (4 * tier))
        cidx, n_cand = compact_mask_indices(pre_cand, Kc)
        csafe = torch.clamp(cidx, max=M - 1).to(torch.int64)
        return csafe, n_cand, n_cand > Kc

    def _brent_candidates(self, c_hist, uc_c, rho_c, solve):
        """Brent on the compacted candidate lanes where `solve`."""
        xs = torch.arange(c_hist.shape[1], dtype=F, device=c_hist.device)
        lsh = self.engine.lsh
        return brent_llh(c_hist.sum(dim=1), (c_hist * xs).sum(dim=1), uc_c,
                         rho_c, solve, lsh.k, lsh.h, self.engine.th)

    def _read_gate(self, n_pres, hist_c):
        """Reads with more than one present leaf that pass the closest
        candidate's leq-tau filter (they place on internal candidates)."""
        leq_tau_c = hist_c[:, : self.cfg.tau + 1].sum(dim=1)
        active = (n_pres > 0) & ((leq_tau_c > 1.0) | self.cfg.no_filter)
        return active & (n_pres > 1)

    def _place_dense(self, tables, packed, vbits, lengths, leaf_ok,
                     tier: int = 0):
        """Probe + stage 2 + DENSE placement aggregation, returning the
        same compacted candidate tuple as the lane path. The gates
        (support, structural, leq-tau, multi-read) apply densely; Brent
        runs only on the compacted candidate lanes."""
        full = self.engine._full_impl(tables, packed, vbits, lengths, leaf_ok,
                                      exact=tier > 0, out_mode="full",
                                      tier=tier)
        with trace.span("stage3"):
            return self._dense_stage3(full, lengths, tier)

    def _dense_stage3(self, full, lengths, tier: int):
        eng = self.engine
        X = eng.th + 1
        (present, hist_f, d_f, v_f, mc_f, uc_f, _rho, best_slot, best_d,
         hist_c, uc_c, rho_c, v_c, _ratio, onmers, flags) = full
        B = present.shape[0]
        Qp = self.Q + 1
        n_pres = present.sum(dim=1, dtype=torch.int32)

        histW, matchW, support, rhoW = self._dense_ancestors(present, hist_f,
                                                             mc_f)
        enmers = (lengths - eng.lsh.k + 1).to(F)
        lq = self._lq
        isl = self._is_leaf_q[None, :]                          # [1, Qp]
        own_p = present[:, lq] & isl                            # [B, Qp]
        hist_q = torch.where(
            isl[..., None],
            torch.where(own_p[..., None], hist_f[:, lq, :].to(F), 0.0),
            histW)
        uc_q = torch.where(isl, torch.where(own_p, uc_f[:, lq],
                                            onmers[:, None].to(F)),
                           enmers[:, None] - matchW)
        rho_q = torch.where(isl, self._rho_of_q[None, :], rhoW)
        leq_tau = hist_q[..., : self.cfg.tau + 1].sum(dim=-1)

        pre_cand = (support & self._cand_struct[None, :]
                    & self._read_gate(n_pres, hist_c)[:, None])
        if not self.cfg.no_filter:
            pre_cand = pre_cand & (leq_tau > 1.0)
        M = B * Qp
        csafe, n_cand, cand_over = self._candidates(pre_cand.reshape(M), B,
                                                    tier)
        overflow = (flags > 0) | cand_over
        c_isl = self._is_leaf_q[csafe % Qp]
        d_opt, v_opt = self._brent_candidates(
            hist_q.reshape(M, X)[csafe], uc_q.reshape(M)[csafe],
            rho_q.reshape(M)[csafe], ~c_isl & support.reshape(M)[csafe])
        o_has = own_p.reshape(M)[csafe]
        cand_d = torch.where(c_isl, torch.where(
            o_has, d_f[:, lq].reshape(M)[csafe], D_MAX), d_opt)
        cand_v = torch.where(c_isl, torch.where(
            o_has, v_f[:, lq].reshape(M)[csafe], 0.0), v_opt)
        # the compacted index is already b * Qp + q, ascending
        return (n_pres, best_slot, best_d, hist_c, uc_c, rho_c, v_c,
                csafe.to(torch.int32), cand_d, cand_v, n_cand, onmers,
                overflow)

    def _place_impl(self, tables, packed, vbits, lengths, leaf_ok,
                    tier: int = 0):
        """Probe + stage 2 + LANE placement aggregation, returning a
        compacted candidate list (ref: src/query.cpp:218-296).

        Each present (read, leaf) lane contributes its minfo to every
        ancestor of its leaf with the damping weight. The events (lane x
        ancestor) sort stably by (read, qnode) key and segment-reduce into
        node lanes; leaf node lanes take the owning slot's minfo verbatim;
        the candidate gate applies per lane; candidates compact to Kc slots
        and only those run Brent. No [B, Q+1] array is materialised.

        tier > 0 re-runs with 16x (tier 1) / 256x (tier 2) capacities and
        the exact full-depth probe; every cap carries an overflow flag."""
        eng = self.engine
        with trace.span("hash"):
            codes = codec.unpack_codes(packed, lengths,
                                       packed.shape[1] * 16, vbits)
        B = codes.shape[0]
        K = min(B * eng.S, max(8 * B, 4096) << (4 * tier))
        L, onmers, probe_ov = eng._probe_and_lanes(
            tables, codes, lengths, leaf_ok, K, tier > 0, tier)
        with trace.span("stage3"):
            return self._lane_stage3(L, onmers, probe_ov, lengths, B, tier)

    def _lane_stage3(self, L, onmers, probe_ov, lengths, B: int, tier: int):
        eng = self.engine
        dev = lengths.device
        Qp = self.Q + 1
        overflow = probe_ov | L["lane_over"]
        lb, ls, lv, pl = L["lb"], L["ls"], L["lv"], L["present_l"]
        seg_b = torch.where(lv, lb, B)
        n_pres = torch.zeros((B + 1,), dtype=torch.int32, device=dev)
        n_pres = n_pres.index_add_(0, seg_b, pl.to(torch.int32))[:B]

        # ---- expand lanes to ancestor events
        Dm = self._Dmax
        M = L["idx"].shape[0] * Dm
        q_e = self._anc_q[ls]                             # [K, Dm]
        own = self._is_owner[ls] & lv                     # [K]
        valid = pl[:, None] & (q_e > 0)
        # the j = 0 (own-leaf) event also rides for non-present owner
        # lanes, carrying the leaf override payload (weight 0 below)
        valid[:, 0] = (pl | own) & (q_e[:, 0] > 0)
        big = B * Qp
        if big >= 2 ** 31:
            raise ValueError(f"{B} reads x {Qp} tree nodes overflow the "
                             "int32 event keys; use smaller batches")
        key_e = torch.where(valid, lb[:, None] * Qp + q_e,
                            big).reshape(M).to(torch.int32)
        ks, ids = torch.sort(key_e, stable=True)
        gvalid = ks < big
        prev = torch.cat([torch.full((1,), -1, dtype=ks.dtype, device=dev),
                          ks[:-1]])
        gfirst = (ks != prev) & gvalid
        gid = torch.clamp(torch.cumsum(gfirst.to(torch.int32), 0) - 1,
                          min=0).to(torch.int64)

        l_of = ids // Dm
        j_of = ids - l_of * Dm
        pl_e = pl[l_of] & gvalid
        w_ev = torch.where(pl_e, self._anc_w[ls[l_of], j_of], 0.0)
        hist_e = L["hist_f"].to(F)[l_of]                   # [M, X]

        def gsum(x):
            z = torch.zeros((M,) + x.shape[1:], dtype=x.dtype, device=dev)
            return z.index_add_(0, gid, x)

        def gmax(x, empty):
            z = torch.full((M,), empty, dtype=x.dtype, device=dev)
            return z.scatter_reduce_(0, gid, x, "amax", include_self=False)

        histW = gsum(w_ev[:, None] * hist_e)
        matchW = gsum(w_ev * L["mc_f"].to(F)[l_of])
        rhoM = gmax(torch.where(pl_e, L["rho_l"][l_of], 0.0), -np.inf)
        sup = gsum(pl_e.to(torch.int32)) > 0
        o_flag = own[l_of] & (j_of == 0) & gvalid
        o_has = gsum(o_flag.to(torch.int32)) > 0
        o_hist = gsum(torch.where(o_flag[:, None], hist_e, 0.0))
        o_d = gsum(torch.where(o_flag, L["d_f"][l_of], 0.0))
        o_v = gsum(torch.where(o_flag, L["v_f"][l_of], 0.0))
        o_uc = gsum(torch.where(o_flag, L["uc_f"][l_of], 0.0))
        gkey = gmax(torch.where(gvalid, ks, -1), torch.iinfo(torch.int32).min)

        # ---- per node-lane values (the dense semantics)
        gval = gkey >= 0
        gkey_c = torch.clamp(gkey, min=0).to(torch.int64)
        gb = gkey_c // Qp
        gq = gkey_c - gb * Qp
        isl = self._is_leaf_q[gq] & gval
        enmers = (lengths - eng.lsh.k + 1).to(F)
        hist_q = torch.where(isl[:, None],
                             torch.where(o_has[:, None], o_hist, 0.0), histW)
        uc_q = torch.where(isl, torch.where(o_has, o_uc, onmers[gb].to(F)),
                           enmers[gb] - matchW)
        rho_q = torch.where(isl, self._rho_of_q[gq], rhoM)
        leq_tau = hist_q[:, : self.cfg.tau + 1].sum(dim=1)

        # ---- candidate gate + compaction
        pre_cand = (gval & sup & self._cand_struct[gq]
                    & self._read_gate(n_pres, L["hist_c"])[gb])
        if not self.cfg.no_filter:
            pre_cand = pre_cand & (leq_tau > 1.0)
        csafe, n_cand, cand_over = self._candidates(pre_cand, B, tier)
        overflow = overflow | cand_over

        # ---- Brent only on compacted candidate lanes
        c_isl = isl[csafe]
        d_opt, v_opt = self._brent_candidates(
            hist_q[csafe], uc_q[csafe], rho_q[csafe], ~c_isl & sup[csafe])
        cand_d = torch.where(c_isl, torch.where(o_has[csafe], o_d[csafe],
                                                D_MAX), d_opt)
        cand_v = torch.where(c_isl, torch.where(o_has[csafe], o_v[csafe],
                                                0.0), v_opt)
        return (n_pres, L["best_slot"], L["best_d"], L["hist_c"], L["uc_c"],
                L["rho_c"], L["v_c"], gkey_c[csafe].to(torch.int32), cand_d,
                cand_v, n_cand, onmers, overflow)

    def run_place_async(self, codes, lengths, leaf_ok, tier: int = 0):
        """Upload a batch and enqueue the fused place step; returns its
        pending 13-tuple (the last element the overflow flag)."""
        impl = self._place_dense if self.dense else self._place_impl
        return self.engine.run_step(functools.partial(impl, tier=tier),
                                    codes, lengths, leaf_ok)

    def run_place_exact(self, codes, lengths, leaf_ok, tier: int = 1):
        """A capacity-tier re-run (exact full-depth probe)."""
        return self.run_place_async(codes, lengths, leaf_ok, tier=tier)

    def chisq_host(self, d_q, hist_c, uc_c, rho_c, v_c) -> np.ndarray:
        """chisq_q = 2 (llh(d_q | closest) - v_closest) on host f64."""
        return 2.0 * (self._llh_np(d_q, hist_c[:, None, :], uc_c[:, None],
                                   rho_c[:, None]) - v_c[:, None])

    def chisq_cand_host(self, cb, cd, hist_c, uc_c, rho_c, v_c) -> np.ndarray:
        """Per-candidate-lane chi-square LRT vs the closest candidate
        (ref: src/query.cpp:284-296), host f64 over compacted lanes."""
        return 2.0 * (self._llh_np(cd, hist_c[cb], uc_c[cb], rho_c[cb])
                      - v_c[cb])


def run_place(dindex: DeviceIndex, query_path: str, out: TextIO,
              invocation: str, cfg: Optional[PlaceConfig] = None,
              qtree=None, engine_factory=None, device="cuda",
              stats: Optional[dict] = None) -> int:
    """Run `place` over query_path, writing the report to `out`; returns the
    number of reads. Up to IN_FLIGHT batches are in flight. A batch whose
    step overflowed a capacity re-runs at tiers 1 and 2 (exact probe); if
    tier 2 overflows too, RuntimeError. If `stats` is a dict it receives the
    engine mode, hflavor, W, the stage-3 formulation and the tier re-runs
    of each batch."""
    cfg = cfg or PlaceConfig()
    with trace.batch(None), trace.span("entry"):
        pv = dindex.placement_view(qtree)
        engine = engine_factory(dindex, cfg.hdist_th) if engine_factory \
            else QueryEngine(dindex, cfg.hdist_th, device=device)
        agg = PlaceAggregator(engine, pv, cfg)
        qflat = pv.qflat
        tree_nwk = pv.qtree.newick(jplace=True, fixed5=True)
        if cfg.summarize or cfg.tabular:
            out.write(place_header(invocation, tree_nwk, cfg.summarize,
                                   cfg.tabular))
        else:
            out.write(begin_jplace())

    leaf_ok = np.asarray(pv.leaf_qse > 0)
    total = 0
    has_previous = False
    wcount = np.zeros(qflat.nnodes + 1)
    reruns: List[int] = []
    pending = deque()

    def flush_one():
        nonlocal has_previous
        names_b, lengths_b, codes_b, dev, bid = pending.popleft()
        with trace.batch(bid):
            fetched = dev.get()
            n = 0
            for tier in (1, 2):
                if not bool(np.any(fetched[-1])):
                    break
                # heavy-tail / lane / candidate capacity overflow: escalate
                # (16x per tier) with the exact full-depth probe
                n += 1
                fetched = agg.run_place_exact(codes_b, lengths_b, leaf_ok,
                                              tier=tier).get()
            else:
                if bool(np.any(fetched[-1])):
                    raise RuntimeError("place capacity tiers exhausted; "
                                       "reduce the batch size")
            reruns.append(n)
            trace.count("place_candidates", int(fetched[10]))
            has_previous = flush_place_batch(
                agg, fetched, names_b, np.asarray(lengths_b), pv, cfg, out,
                wcount, has_previous)

    batch_bp = min(cfg.batch_bp,
                   engine.suggested_batch_reads(place=True) * 150)
    mult = getattr(engine, "n_data", 1)
    batches = iter(QueryBatcher(query_path, bp_limit=batch_bp))
    while True:
        with trace.span("prep"):
            batch = next(batches, None)
            if batch is None:
                break
            names, seqs = batch
            total += len(names)
            codes, lengths = codec.pad_codes_batch(
                seqs, pad_to=_bucket_len(int(seqs.lengths.max())))
            note_batch(lengths, dindex.lsh.k)
            codes, lengths = _pad_batch(codes, lengths, mult)
        pending.append((names, lengths, codes,
                        agg.run_place_async(codes, lengths, leaf_ok),
                        trace.current_batch()))
        if len(pending) >= IN_FLIGHT:
            flush_one()
    while pending:
        flush_one()
    with trace.batch(None), trace.span("report"):
        if cfg.summarize:
            twcount = wcount.sum()
            qs = np.flatnonzero(wcount)
            for q in qs:
                w = wcount[q]
                nm = qflat.names[q] if qflat.names[q] else "NA"
                out.write(f"{nm}\t{q - 1}\t{fmt5(w)}\t"
                          f"{fmt5(w / twcount)}\n")
            trace.count("rows", len(qs))
        elif not cfg.tabular:
            out.write(end_jplace(invocation, total, tree_nwk))
    if stats is not None:
        stats.update(mode=engine.mode, hflavor=engine.hflavor, W=engine.W,
                     formulation="dense" if agg.dense else "lanes",
                     batches=len(reruns), escalations=reruns)
    return total


def flush_place_batch(agg: PlaceAggregator, fetched, names_b, lengths_b,
                      pv: PlacementView, cfg: PlaceConfig, out: TextIO,
                      wcount: np.ndarray, has_previous: bool) -> bool:
    """Host half of one fused place batch: unpack the fetched tuple,
    chi-square the compacted candidate lanes, drop the batch's padding
    reads, keep this process's slice (cfg.emit_slice), emit the report."""
    with trace.span("report"):
        return _flush_place(agg, fetched, names_b, lengths_b, pv, cfg, out,
                            wcount, has_previous)


def _flush_place(agg, fetched, names_b, lengths_b, pv, cfg, out, wcount,
                 has_previous):
    (n_pres, best_slot, best_d, hist_c, uc_c, rho_c, v_c,
     cand_key, cand_d, cand_v, n_cand, onmers, _ov) = fetched
    m = min(int(n_cand), len(cand_key))
    Qp = agg.Q + 1
    idx = np.asarray(cand_key[:m], np.int64)
    cb = idx // Qp
    cq = idx % Qp
    cd = np.asarray(cand_d[:m])
    cv = np.asarray(cand_v[:m])
    chisq_c = agg.chisq_cand_host(cb, cd, hist_c, uc_c, rho_c, v_c)
    lo, hi = 0, len(names_b)
    if cfg.emit_slice:
        rank, nranks = cfg.emit_slice
        lo, hi = rank * hi // nranks, (rank + 1) * hi // nranks
    if (lo, hi) != (0, len(n_pres)):
        keep = (cb >= lo) & (cb < hi)
        cb, cq, cd, cv, chisq_c = (cb[keep] - lo, cq[keep], cd[keep],
                                   cv[keep], chisq_c[keep])
        n_pres, best_slot, best_d, hist_c, uc_c, rho_c, v_c, onmers = (
            x[lo:hi] for x in (n_pres, best_slot, best_d, hist_c, uc_c,
                               rho_c, v_c, onmers))
        names_b, lengths_b = names_b[lo:hi], lengths_b[lo:hi]
    lr = LeafResults(
        present=None, d=None, closest_slot=best_slot,
        closest_d=best_d, hist_closest=hist_c, uc_closest=uc_c,
        rho_closest=rho_c, v_closest=v_c, onmers=np.asarray(onmers),
        lengths=lengths_b)
    return _report_batch(lr, np.asarray(n_pres), names_b, pv, cfg, out,
                         wcount, has_previous, cb, cq, cd, cv, chisq_c)


def _row_fields(qflat, qs: np.ndarray, d: np.ndarray, v: np.ndarray,
                lwr: np.ndarray):
    """The five float fields of jplace rows: (pendant, distal, likelihood,
    lwr, distance), as the reference's jplace row (ref:
    src/query.hpp:197-204)."""
    blen = qflat.blen[qs]
    pend = np.where(np.isnan(blen), 0.0, blen / 2.0)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        jc = -0.75 * np.log(1.0 - (4.0 / 3.0) * d)
    return jc - pend, pend, -v, lwr, d


def _native_fits(fields) -> bool:
    """True when each field renders within csrc/report.c's 192-byte rows:
    NaN, inf, or finite below NATIVE_FIELD_MAX in magnitude."""
    return not any(np.any(np.isfinite(x) & (np.abs(x) >= NATIVE_FIELD_MAX))
                   for x in fields)


def _jplace_rows_bulk(qflat, qs: np.ndarray, d: np.ndarray, v: np.ndarray,
                      lwr: np.ndarray) -> np.ndarray:
    """Vectorized jplace rows over candidate arrays -> object str array."""
    en = (qs - 1).astype(str).astype(object)
    out = "[" + en
    for x in _row_fields(qflat, qs, d, v, lwr):
        out = out + ", " + fmt5_array(x)
    return out + "]"


def _report_batch(lr: LeafResults, n_pres: np.ndarray, names: List[str],
                  pv: PlacementView, cfg: PlaceConfig, out: TextIO,
                  wcount: np.ndarray, has_previous: bool,
                  cb, cq, cd, cv, chisq_c) -> bool:
    """Bulk-vectorized report pass (ref: src/query.cpp:218-333).

    cb/cq/cd/cv/chisq_c are the device-compacted pre-chisq candidate lanes
    in row-major (read, qnode) order; this pass applies the chi-square LRT
    filter, normalises LWRs and emits rows batch-wide."""
    qflat = pv.qflat
    B = len(n_pres)
    tau = cfg.tau
    names_a = np.asarray(names, dtype=object)

    leq_tau_c = lr.hist_closest[:, : tau + 1].sum(axis=1)
    active = (n_pres > 0) & (cfg.no_filter | (leq_tau_c > 1.0))
    single = active & (n_pres == 1)

    # single-match reads place on the closest leaf's edge with LWR 1
    sb = np.flatnonzero(single)
    s_q = pv.leaf_qse[lr.closest_slot[sb]].astype(np.int64)
    s_d = lr.closest_d[sb]
    s_v = lr.v_closest[sb]

    # chi-square LRT filter over the compacted candidates
    # (ref: src/query.cpp:284-296)
    keep = chisq_c < cfg.chisq_value
    cb, cq, cd, cv = cb[keep], cq[keep], cd[keep], cv[keep]
    lwr = np.exp(-chisq_c[keep] / 2.0)
    tot = np.bincount(cb, weights=lwr, minlength=B)
    counts = np.bincount(cb, minlength=B)
    with np.errstate(invalid="ignore", divide="ignore"):
        cw = lwr / tot[cb]

    if not cfg.multi and len(cb):
        # best by highest card, then lowest distance, then highest edge id
        # -- the last element of the reference's stable (card, -d) sort
        # (ref: src/query.cpp:312-319)
        order = np.lexsort((-cq, cd, -qflat.card[cq], cb))
        _, first = np.unique(cb[order], return_index=True)
        pick = order[first]
        cb, cq, cd, cv, cw = cb[pick], cq[pick], cd[pick], cv[pick], cw[pick]
        counts = np.minimum(counts, 1)

    if not cfg.summarize:
        trace.count("rows", len(sb) + len(cb))
    if cfg.summarize:
        np.add.at(wcount, s_q, 1.0)
        if cfg.multi:
            with np.errstate(divide="ignore"):
                np.add.at(wcount, cq, 1.0 / counts[cb])
        else:
            np.add.at(wcount, cq, 1.0)
        return has_previous

    if cfg.tabular:
        qn = np.asarray([x if x else "NA" for x in qflat.names], object)
        srows = (names_a[sb] + "\t" + qn[s_q] + "\t"
                 + (s_q - 1).astype(str).astype(object) + "\t1.00000\t"
                 + fmt5_array(s_d) + "\n")
        crows = (names_a[cb] + "\t" + qn[cq] + "\t"
                 + (cq - 1).astype(str).astype(object) + "\t"
                 + fmt5_array(cw) + "\t" + fmt5_array(cd) + "\n")
        order = np.argsort(np.concatenate([sb, cb]), kind="stable")
        out.write("".join(np.concatenate([srows, crows])[order].tolist()))
        return has_previous

    starts = np.searchsorted(cb, np.arange(B))
    ends = np.searchsorted(cb, np.arange(B) + 1)
    s_of = np.full(B, -1, np.int64)
    s_of[sb] = np.arange(len(sb))
    s_w = np.ones(len(sb))
    # the C bulk emitter renders the batch unless a field would overrun its
    # fixed-size rows (a D_MAX distance prints 315 characters)
    if (_native_fits(_row_fields(qflat, s_q, s_d, s_v, s_w))
            and _native_fits(_row_fields(qflat, cq, cd, cv, cw))):
        kind = np.zeros(B, np.uint8)
        kind[active & single] = 1
        if cfg.multi:
            kind[active & ~single] = 2
        else:
            kind[active & ~single & (ends > starts)] = 2
        frag, emitted = native_report.jplace_emit(
            names, kind, s_of, starts, ends, s_q, s_d, s_v, cq, cd, cv, cw,
            qflat.blen, cfg.multi, has_previous)
        out.write(frag)
        return has_previous or emitted > 0

    srows = _jplace_rows_bulk(qflat, s_q, s_d, s_v, s_w)
    crows = _jplace_rows_bulk(qflat, cq, cd, cv, cw)
    parts: List[str] = []
    for b in np.flatnonzero(active):
        if single[b]:
            body = srows[s_of[b]] + "]}"
        elif cfg.multi:
            body = (",".join("\n\t\t\t\t" + r
                             for r in crows[starts[b]: ends[b]])
                    + "]\n\t\t\t}")
        elif ends[b] > starts[b]:
            body = crows[starts[b]] + "]}"
        else:
            continue
        if has_previous:
            parts.append(",\n")
        parts.append(f'\t\t\t{{"n" : ["{names[b]}"], "p" : [' + body)
        has_previous = True
    out.write("".join(parts))
    return has_previous
