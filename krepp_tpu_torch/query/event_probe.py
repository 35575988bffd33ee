"""Event-formulated stage-1 probe for indexes without leaf bitmasks.

Port of `event_probe_lanes` from krepp_tpu/query/event_probe.py (see that
module's docstring for the formulation and the reference citations).
Matched (probe lane, color, hd) events expand through the per-color
leaf-slot CSR into (strand-read, leaf, position, hd) events, which a sort
dedupes per position; everything stays in compacted lane form, so memory
and work are independent of the leaf count S. Every fixed capacity (KR
resident lanes, KH heavy probes, E matches per ultra-deep probe, CAP_L
leaf events) raises the overflow flag; the engine re-runs such a batch at
a larger tier, so no result is ever silently truncated.

JAX -> torch: `lax.sort` of two keys is one sort of an int64 composite key
(or two stable sorts when the keys do not fit 63 bits); `.at[].add(...,
mode="drop")` scatters into one padding slot that is sliced off;
segment sums / mins / maxes are `index_add_` / `scatter_reduce` on int32,
whose integer atomics give the same answer in any order.

Host syncs: one, for the loop bound of the ultra-deep E-slot scan (the
deepest bucket it must cover), when buckets exceed the heavy tail's width.

The reference's dense form (`event_probe`, a [2B, S, X] histogram) is not
ported: the single-device and the sharded engines both run event mode in
lane form.
"""

from __future__ import annotations

import torch

from ..core.codec import hdist_lr32
from ..core.compact import compact_mask_indices, compact_mask_indices_strided
from ..core.host_turn import host_int
from .kernels import HD_SENTINEL

# heavy buckets up to this depth are rescanned with one unrolled padded
# gather; deeper buckets take the E-slot loop
EVENT_TAIL_UNROLL = 24
_I32_MIN = torch.iinfo(torch.int32).min


def heavy_id(word0: torch.Tensor, nh: int) -> torch.Tensor:
    """Heavy-table row of a count word packed as cnt | (hid + 1) << 8.

    The word is a u32 bit pattern in int32, whose `>>` is arithmetic: the
    mask keeps ids >= 2^23 from sign-extending (the reference's decode
    clips them to row 0; ROADMAP Queue 3)."""
    return torch.clamp(((word0 >> 8) & 0xFFFFFF) - 1, 0, nh - 1).long()


def _shift_prev(x: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def sort_events(nb, leaf, k3, tv, N: int, S: int, packed=None):
    """Sort leaf events by (strand-read, leaf, k3 = pos * 8 + hd).

    Invalid events (tv false) sort last with strand-read N. Returns
    (k1s, k2s, k3s, new_lane): the sorted keys and the first-of-lane flag.
    (strand-read, leaf) packs into one 31-bit key whenever it fits, and the
    sort is then one int64 composite sort; otherwise two stable sorts
    (k3, then the 63-bit (strand-read, leaf) key). `packed` forces a
    branch (tests)."""
    sbits = max(S - 1, 1).bit_length()
    if packed is None:
        packed = ((N + 1) << sbits) < 2 ** 31
    k3 = k3.long()
    if packed:
        kl = torch.where(tv, (nb.long() << sbits) | leaf.long(), N << sbits)
        key = torch.sort((kl << 32) | k3).values
        kls = key >> 32
        k3s = key & 0xFFFFFFFF
        k1s = kls >> sbits
        k2s = kls & ((1 << sbits) - 1)
        new_lane = kls != _shift_prev(kls, -1)
    else:
        k1 = torch.where(tv, nb.long(), N)
        o1 = torch.sort(k3, stable=True).indices
        kl = (k1 << sbits) | leaf.long()
        perm = o1[torch.sort(kl[o1], stable=True).indices]
        k1s, k2s, k3s = k1[perm], leaf.long()[perm], k3[perm]
        new_lane = ((k1s != _shift_prev(k1s, -1))
                    | (k2s != _shift_prev(k2s, -1)))
    return k1s, k2s, k3s, new_lane


def event_probe_lanes(slots_d, enc_se, row_start, leaf_off, leaf_slots,
                      sidx, hrow, resident, res2, th: int, C0: int, S: int,
                      max_bucket: int, E: int, KH: int, CAP_L: int,
                      heavy_tab=None, KR=None):
    """Lane-form event probe over pre-routed probes [2, B, P].

    slots_d: 'se' bucket rows int32 [nrows, 1 + 2*C0] (count word, C0 encs,
    C0 color ids); enc_se int32 [nk, 2]; row_start int64; leaf_off int64
    [nse + 1]; leaf_slots int32; heavy_tab int32 [nh, 1 + 2*MB] (count,
    then (enc, color id) pairs) or None for the CSR tail; KR the resident
    compaction capacity (None: no compaction).

    Returns (nb_lane [CAP_L] int32, N for an empty lane; leaf_lane [CAP_L]
    int32; hist_lanes [CAP_L, th+1] int32; minall [N] int32; overflow bool
    tensor), one lane per (strand-read, leaf) in ascending order."""
    X = th + 1
    dev = res2.device
    _, B, P = sidx.shape
    N = 2 * B
    Np = N * P
    nk = max(enc_se.shape[0], 1)

    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    # ------------------------------------------ resident-lane compaction
    if KR is not None and KR < Np:
        # (sidx, res, hrow) ride in one 3-word row: one gather
        fields = torch.stack([sidx.reshape(Np).to(torch.int32),
                              res2.reshape(Np),
                              hrow.reshape(Np).to(torch.int32)], dim=1)
        ridx, nres, r_over = compact_mask_indices_strided(
            resident.reshape(Np), KR)
        overflow = (nres > KR) | r_over
        res_live = ridx < Np
        lane_of = torch.clamp(ridx, max=Np - 1).long()   # original lane ids
        fr = fields[lane_of]
        sidx_c = fr[:, 0].long()
        res_c = fr[:, 1]
        hrow_c = fr[:, 2].long()
    else:
        sidx_c = sidx.reshape(Np)
        res_c = res2.reshape(Np)
        hrow_c = hrow.reshape(Np)
        res_live = resident.reshape(Np)
        lane_of = torch.arange(Np, dtype=torch.int64, device=dev)
    NL = sidx_c.shape[0]

    # ---------------------------------------------------------- light pass
    d = slots_d[sidx_c]                                  # [NL, 1+2C0]
    word0 = d[:, 0]
    cnt = torch.where(res_live, word0 & 255 if heavy_tab is not None
                      else word0, 0)
    heavy = cnt > C0
    light = res_live & ~heavy
    hd_l = hdist_lr32(d[:, 1: 1 + C0], res_c[:, None])   # [NL, C0]
    jc = torch.arange(C0, dtype=torch.int32, device=dev)
    lm = light[:, None] & (jc < cnt[:, None]) & (hd_l <= th)
    sehd_l = torch.where(lm, d[:, 1 + C0: 1 + 2 * C0] * 8 + hd_l, 0)

    # ----------------------------------------------------------- heavy tail
    ML = NL * C0
    ev_ok_parts = [lm.reshape(ML)]
    deep_loop = False
    if max_bucket > C0:
        hidx, nheavy, blk_over = compact_mask_indices_strided(heavy, KH)
        overflow = overflow | (nheavy > KH) | blk_over
        KHa = hidx.shape[0]
        live = hidx < NL                                 # only set lanes
        hsafe = torch.clamp(hidx, max=NL - 1).long()
        hres = res_c[hsafe]
        hlane = lane_of[hsafe]                           # original lane ids
        start = None
        if heavy_tab is not None:
            MB = (heavy_tab.shape[1] - 1) // 2
            hrow_t = heavy_tab[heavy_id(word0[hsafe], heavy_tab.shape[0])]
            hcnt = torch.where(live, hrow_t[:, 0], 0)
            hd_h = hdist_lr32(hrow_t[:, 1::2], hres[:, None])
            se_h = hrow_t[:, 2::2]
        else:
            hurow = hrow_c[hsafe]
            start = row_start[hurow]
            hcnt = torch.where(live, row_start[hurow + 1] - start,
                               0).to(torch.int32)
            MB = min(max_bucket, EVENT_TAIL_UNROLL)
            jj = torch.arange(MB, dtype=torch.int64, device=dev)
            pair_h = enc_se[torch.clamp(start[:, None] + jj, max=nk - 1)]
            hd_h = hdist_lr32(pair_h[..., 0], hres[:, None])
            se_h = pair_h[..., 1]
        jj = torch.arange(MB, dtype=torch.int32, device=dev)
        match_h = (jj < torch.clamp(hcnt, max=MB)[:, None]) & (hd_h <= th)
        sehd_h = torch.where(match_h, se_h * 8 + hd_h, 0)
        MH = KHa * MB
        ev_ok_parts.append(match_h.reshape(MH))
        if max_bucket > MB:
            # ultra-deep remainder: E-slot insertion loop from j = MB
            deep_loop = True
            K2 = max(KH // 8, 256)
            didx, ndeep = compact_mask_indices(live & (hcnt > MB), K2)
            overflow = overflow | (ndeep > K2)
            K2a = didx.shape[0]
            dsafe = torch.clamp(didx, max=KHa - 1).long()
            dlive = didx < KHa
            dcnt = torch.where(dlive, hcnt[dsafe], 0)
            dstart = (row_start[hrow_c[hsafe[dsafe]]] if start is None
                      else start[dsafe])
            dres = hres[dsafe]
            je = torch.arange(E, dtype=torch.int32, device=dev)
            bsehd = torch.zeros((K2a, E), dtype=torch.int32, device=dev)
            nm = torch.zeros((K2a,), dtype=torch.int32, device=dev)
            hmax = min(host_int(dcnt.max()), max_bucket) if K2a else 0
            for j in range(MB, hmax):
                pr = enc_se[torch.clamp(dstart + j, max=nk - 1)]
                hdd = hdist_lr32(pr[:, 0], dres)
                m = (j < dcnt) & (hdd <= th)
                put = m[:, None] & (nm[:, None] == je)
                bsehd = torch.where(put, (pr[:, 1] * 8 + hdd)[:, None],
                                    bsehd)
                nm = nm + m.to(torch.int32)
            overflow = overflow | (nm > E).any()
            MD = K2a * E
            ev_ok_parts.append((dlive[:, None]
                                & (je < torch.clamp(nm, max=E)[:, None])
                                ).reshape(MD))

    # --------------------------- compact matched events, then gather fields
    ev_ok = torch.cat(ev_ok_parts)
    Mtot = ev_ok.shape[0]
    eidx_c, nev, ev_blk_over = compact_mask_indices_strided(ev_ok, CAP_L)
    overflow = overflow | (nev > CAP_L) | ev_blk_over
    ev_valid = eidx_c < Mtot
    esafe = torch.clamp(eidx_c, max=Mtot - 1).long()
    # piecewise source decode: light block, heavy block, deep block
    in_light = esafe < ML
    lsafe = torch.clamp(esafe, max=ML - 1)
    ev_sehd = torch.where(in_light, sehd_l.reshape(ML)[lsafe], 0)
    ev_lane = torch.where(in_light, lane_of[lsafe // C0], 0)
    if max_bucket > C0:
        hoff = esafe - ML
        in_heavy = (esafe >= ML) & (hoff < MH)
        hsafe2 = torch.clamp(hoff, 0, MH - 1)
        ev_sehd = torch.where(in_heavy, sehd_h.reshape(MH)[hsafe2], ev_sehd)
        ev_lane = torch.where(in_heavy, hlane[hsafe2 // MB], ev_lane)
        if deep_loop:
            doff = esafe - ML - MH
            in_deep = doff >= 0
            dsafe2 = torch.clamp(doff, 0, MD - 1)
            ev_sehd = torch.where(in_deep, bsehd.reshape(MD)[dsafe2],
                                  ev_sehd)
            ev_lane = torch.where(in_deep, hlane[dsafe[dsafe2 // E]],
                                  ev_lane)
    ev_sehd = torch.where(ev_valid, ev_sehd, 0)

    # --------------------------------------------- color -> leaf expansion
    # Event e owns output slots [cum[e] - cards[e], cum[e]); the owner of
    # slot t is recovered with one mark scatter + cumsum. The three fields
    # the expansion needs (start slot, leaf-CSR offset, lane * 8 + hd) ride
    # in one packed row, so the per-slot fetch is one row gather.
    se_ok = (ev_sehd >> 3).long()
    offs = leaf_off[se_ok]
    cards = torch.where(ev_valid, leaf_off[se_ok + 1] - offs, 0)
    cum = torch.cumsum(cards, 0)
    T = cum[-1]
    overflow = overflow | (T > CAP_L)
    starts = cum - cards
    marks = torch.zeros((CAP_L + 1,), dtype=torch.int32, device=dev)
    marks.index_add_(0, torch.clamp(starts, max=CAP_L),
                     torch.ones_like(starts, dtype=torch.int32))
    evc = torch.clamp(torch.cumsum(marks[:CAP_L], 0) - 1, min=0)
    t = torch.arange(CAP_L, dtype=torch.int64, device=dev)
    tv = t < torch.clamp(T, max=CAP_L)
    lanehd = ev_lane.to(torch.int32) * 8 + (ev_sehd & 7)
    trio = torch.stack([starts.to(torch.int32),
                        (offs - starts).to(torch.int32), lanehd], dim=1)
    tr = trio[evc]                                       # [CAP_L, 3]
    lidx = torch.clamp(tr[:, 1].long() + t, 0,
                       max(leaf_slots.shape[0] - 1, 0))
    leaf = torch.where(tv, leaf_slots[lidx], 0)
    lane_t = tr[:, 2] >> 3
    nb = lane_t // P
    k3 = (lane_t - nb * P) * 8 + (tr[:, 2] & 7)

    # ------------------------------------------------- sort + dedupe + hist
    k1s, hd_s, valid_s, nb_lane, leaf_lane, hist_lanes = _dedupe_lanes(
        nb, leaf, k3, tv, N, S, X)
    # every match is an event (or the batch re-runs on overflow), so the
    # per-strand-read minimum hd is one segment-min of the sorted events
    minall = torch.full((N + 1,), HD_SENTINEL, dtype=torch.int32, device=dev)
    minall = minall.scatter_reduce(
        0, torch.clamp(k1s, max=N), torch.where(valid_s, hd_s, HD_SENTINEL),
        "amin")[:N]
    return nb_lane, leaf_lane, hist_lanes, minall, overflow


def _dedupe_lanes(nb, leaf, k3, tv, N: int, S: int, X: int):
    """Sort leaf events, keep the first per (strand-read, leaf, position)
    and sum them into one histogram lane per (strand-read, leaf).

    Returns (k1s sorted strand-reads, hd_s int32 sorted hds, valid_s,
    nb_lane [CAP_L] int32 with N for an empty lane, leaf_lane [CAP_L]
    int32, hist_lanes [CAP_L, X] int32); lanes ascend."""
    CAP_L = nb.shape[0]
    dev = nb.device
    k1s, k2s, k3s, new_lane = sort_events(nb, leaf, k3, tv, N, S)
    valid_s = k1s < N
    ps = k3s >> 3
    first = (new_lane | (ps != _shift_prev(ps, -1))) & valid_s
    lane_id = torch.clamp(torch.cumsum((new_lane & valid_s).to(torch.int32),
                                       0) - 1, min=0).long()
    hd_s = (k3s & 7).to(torch.int32)
    xs = torch.arange(X, dtype=torch.int32, device=dev)
    contrib = ((hd_s[:, None] == xs) & first[:, None]).to(torch.int32)
    hist_lanes = torch.zeros((CAP_L, X), dtype=torch.int32, device=dev)
    hist_lanes.index_add_(0, lane_id, contrib)

    def seg_max(x):
        z = torch.full((CAP_L,), _I32_MIN, dtype=torch.int32, device=dev)
        return z.scatter_reduce_(0, lane_id, x.to(torch.int32), "amax",
                                 include_self=False)

    nb_lane = seg_max(torch.where(valid_s, k1s, -1))
    leaf_lane = seg_max(torch.where(valid_s, k2s, 0))
    nb_lane = torch.where(nb_lane >= 0, nb_lane, N)
    return k1s, hd_s, valid_s, nb_lane, leaf_lane, hist_lanes

