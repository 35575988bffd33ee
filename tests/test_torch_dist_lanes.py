"""dist's host results as lanes (query/engine.DistLanes): the lane decode
of the step's packed present bits, the closest distance read from the
lanes, the [B, S] views built from them on demand, `LeafResults.select` and
`dist._report_rows` against the dense forms they replace, byte for byte."""

import io
import math

import numpy as np
import pytest
import torch

from krepp_tpu_torch.core import codec, trace
from krepp_tpu_torch.core.llh import make_llh_np
from krepp_tpu_torch.index.build import build_index
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.io.fastx import QueryBatcher
from krepp_tpu_torch.params import IndexParams, LSHParams
from krepp_tpu_torch.query import dist
from krepp_tpu_torch.query import engine as qengine
from krepp_tpu_torch.query.engine import D_MAX, DistLanes, LeafResults
from krepp_tpu_torch.tree.newick import Tree
from krepp_tpu_torch.reports import fmt5_array

import worldgen

torch.set_num_threads(1)

WIDTHS = (1, 31, 32, 33, 132, 1000, 1025)


def _random_words(rng, B, S):
    """int32 [B, Wp] words with random bits, bit 31 set in many words, a
    quarter of the rows empty."""
    Wp = (S + 31) // 32
    w = rng.integers(0, 1 << 32, size=(B, Wp), dtype=np.uint64)
    w &= rng.integers(0, 1 << 32, size=(B, Wp), dtype=np.uint64)
    w[rng.random(B) < 0.25] = 0
    w[rng.random((B, Wp)) < 0.3] |= np.uint64(1 << 31)
    return w.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("source", ["random_words", "packed"])
@pytest.mark.parametrize("S", WIDTHS)
def test_lane_decode_equals_dense_unpack(S, source):
    rng = np.random.default_rng(S)
    B = 37
    if source == "random_words":
        words = _random_words(rng, B, S)   # bits past S too: ignored
    else:
        present = rng.random((B, S)) < 0.05
        present[::4] = False
        present[1, -1] = present[2, 0] = True
        present[3, min(31, S - 1)] = True          # bit 31 where S > 31
        words = codec.pack_bits_device(torch.from_numpy(present)).numpy()
        assert np.array_equal(codec.unpack_bits_host(words, S), present)
    assert (words < 0).any() or S < 32
    b, s = codec.set_bits_host(words, S)
    want = np.flatnonzero(codec.unpack_bits_host(words, S))
    assert np.array_equal(b * S + s, want)
    assert b.dtype == s.dtype == np.int64


def _dense_lanes(rng, B, S, p=0.1):
    present = rng.random((B, S)) < p
    present[0] = False                     # a read without lanes
    d = np.where(present, rng.random((B, S)) * 0.2, D_MAX)
    return present, d


@pytest.mark.parametrize("S", WIDTHS)
def test_closest_d_equals_the_grids(S):
    rng = np.random.default_rng(100 + S)
    B = 40
    present, d = _dense_lanes(rng, B, S)
    present[1:5, 0], d[1:5, 0] = True, 0.01    # lanes at max(-1, 0)
    lanes = DistLanes.from_dense(present, d)
    slot = rng.integers(0, S, size=B).astype(np.int32)
    slot[:5] = -1                          # no best leaf
    slot[5] = np.flatnonzero(~present[5])[0] if not present[5].all() else 0
    slot[6:9] = [np.flatnonzero(r)[0] if r.any() else 0
                 for r in present[6:9]]
    got = lanes.at_slot(slot)
    want = np.where(slot >= 0, d[np.arange(B), np.maximum(slot, 0)], D_MAX)
    assert np.array_equal(got, want)
    assert (got == D_MAX).sum() > 5
    assert np.array_equal(DistLanes.from_dense(present[:0], d[:0])
                          .at_slot(slot), np.full(B, D_MAX))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 40-leaf world (two mask words) from FASTA, its index and 42 reads,
    two of them random (NA rows)."""
    rng = np.random.default_rng(40)
    d = tmp_path_factory.mktemp("torch_dist_lanes")
    nwk, genomes = worldgen.make_world(rng, nleaves=40, glen=1200, rate=0.05)
    input_map = []
    for name in sorted(genomes):
        p = d / f"{name}.fna"
        with open(p, "w") as f:
            for i, contig in enumerate(genomes[name]):
                f.write(f">{name}_c{i}\n{contig}\n")
        input_map.append((name, str(p)))
    params = IndexParams(lsh=LSHParams.generate(27, 11, 2, seed=3),
                         w=35, r=1, frac=True)
    built = build_index(input_map, params, Tree.parse(nwk), progress=False)
    qpath = d / "q.fq"
    with open(qpath, "w") as f:
        for rid, seq in worldgen.sample_reads(rng, genomes, n=40, mut=0.05):
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    names, seqs = next(iter(QueryBatcher(str(qpath), bp_limit=1 << 30)))
    codes, lengths = codec.pad_codes_batch(seqs, pad_to=192)
    return DeviceIndex.from_built(built), names, codes, lengths


@pytest.fixture(scope="module")
def engines(world):
    """The world's engine in hybrid mode and in (forced) event mode."""
    out = {}
    for mode in ("hybrid", "event"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(qengine, "FORCE_EVENT", mode == "event")
            out[mode] = qengine.QueryEngine(world[0], 4, device="cpu")
        assert out[mode].mode == mode
    return out


def _old_dense_fetch(eng, fetched):
    """The [B, S] arrays the dist fetch built before its lanes."""
    bits, dval, best_slot = fetched[:3]
    B, S = bits.shape[0], eng.S
    present = codec.unpack_bits_host(bits, S)
    d = np.full((B, S), D_MAX)
    lanes = np.flatnonzero(present.reshape(-1))
    d.reshape(-1)[lanes] = dval[: len(lanes)]
    closest_d = np.where(best_slot >= 0,
                         d[np.arange(B), np.maximum(best_slot, 0)], D_MAX)
    return present, d, closest_d


def _old_ratio(eng, lr, d):
    llh = make_llh_np(eng.lsh.k, eng.lsh.h, eng.th)
    return 2.0 * (llh(d, lr.hist_closest[:, None, :], lr.uc_closest[:, None],
                      lr.rho_closest[:, None]) - lr.v_closest[:, None])


def _fetch(eng, world, out_mode):
    _, names, codes, lengths = world
    fetched = eng.run_leaf_stage_async(codes, lengths,
                                       out_mode=out_mode).get()
    lr = eng.fetch_prefetched(fetched, lengths, codes=codes,
                              out_mode=out_mode)
    if out_mode == "dist_ratio":
        lr.lanes.ratio = eng.compute_ratio_host(lr)
    return fetched, lr


@pytest.mark.parametrize("out_mode", ["dist", "dist_ratio"])
@pytest.mark.parametrize("mode", ["hybrid", "event"])
def test_lazy_views_equal_the_dense_fetch(world, engines, mode, out_mode):
    eng = engines[mode]
    trace.reset()
    trace.enable()
    try:
        fetched, lr = _fetch(eng, world, out_mode)
        assert "dense_views" not in trace.snapshot()["counts"]
        assert eng.escalations == 0
        present, d, closest_d = _old_dense_fetch(eng, fetched)
        assert present.sum() > 40 and not present.all(axis=1).any()
        assert np.array_equal(lr.closest_d, closest_d)
        assert np.array_equal(lr.present, present)
        assert lr.present.dtype == bool
        assert np.array_equal(lr.d, d)
        views = 2
        if out_mode == "dist_ratio":
            ratio = _old_ratio(eng, lr, d)
            assert np.isnan(ratio[~present]).all()
            assert np.array_equal(lr.ratio, ratio, equal_nan=True)
            views += 1
        else:
            assert lr.ratio is None
        assert lr.present is lr.present          # built once, kept
        assert trace.snapshot()["counts"]["dense_views"] == views
    finally:
        trace.disable()
        trace.reset()


def _leaf_results(rng, B, S, n_lanes):
    """A lane-form LeafResults of B reads with exactly n_lanes lanes."""
    flat = np.sort(rng.choice(B * S, size=n_lanes, replace=False))
    b, s = np.divmod(flat, S)
    lanes = DistLanes(b, s, rng.random(n_lanes), S,
                      ratio=rng.random(n_lanes) * 4)
    slot = rng.integers(-1, S, size=B).astype(np.int32)
    return LeafResults(
        present=None, d=None, closest_slot=slot,
        closest_d=lanes.at_slot(slot), hist_closest=rng.random((B, 5)),
        uc_closest=rng.random(B), rho_closest=rng.random(B),
        v_closest=rng.random(B), onmers=None,
        lengths=np.full(B, 150, np.int32), lanes=lanes)


RANGES = [(0, 7), (1, 6), (3, 4), (0, 0), (7, 7)] + [
    (r * 7 // n, (r + 1) * 7 // n) for n in (2, 3) for r in range(n)]


@pytest.mark.parametrize("lo,hi", RANGES)
def test_slice_results_when_lanes_equal_reads(lo, hi):
    B, S = 7, 5
    lr = _leaf_results(np.random.default_rng(lo * 10 + hi), B, S, B)
    assert len(lr.lanes.b) == B
    got = lr.select(lo, hi)
    assert got.__dict__["present"] is None          # still not built
    assert len(got.lengths) == hi - lo
    for f in ("closest_slot", "closest_d", "hist_closest", "uc_closest",
              "rho_closest", "v_closest", "lengths"):
        assert np.array_equal(getattr(got, f), getattr(lr, f)[lo:hi]), f
    assert np.array_equal(got.present, lr.present[lo:hi])
    assert np.array_equal(got.d, lr.d[lo:hi])
    assert np.array_equal(got.ratio, lr.ratio[lo:hi], equal_nan=True)
    keep = (lr.lanes.b >= lo) & (lr.lanes.b < hi)
    assert np.array_equal(got.lanes.b, lr.lanes.b[keep] - lo)
    assert np.array_equal(got.lanes.s, lr.lanes.s[keep])


def _old_report_rows(lr, names, leaf_names, cfg, out, wcount):
    """dist._report_rows as it read the [B, S] grids."""
    B, S = lr.present.shape
    dist_max = cfg.dist_max
    no_dmax = math.isnan(dist_max)
    names_a = np.asarray(names, dtype=object)
    if cfg.summarize:
        sel = lr.present & (lr.ratio < cfg.chisq_value)
        if not no_dmax:
            sel &= lr.d < dist_max
        cnt = sel.sum(axis=1)
        w = np.zeros(B)
        np.divide(1.0, cnt, out=w, where=cnt > 0)
        bs, ss = np.nonzero(sel)
        np.add.at(wcount, ss, w[bs])
        return 0
    leaf_a = np.asarray(leaf_names, dtype=object)
    na = ~lr.present.any(axis=1)
    if not no_dmax:
        na |= lr.closest_d > dist_max
    if cfg.multi:
        sel = lr.present & ~na[:, None]
        if not cfg.no_filter:
            sel &= lr.ratio < cfg.chisq_value
        if not no_dmax:
            sel &= lr.d < dist_max
        bs, ss = np.nonzero(sel)
        rows = (names_a[bs] + "\t" + leaf_a[ss] + "\t"
                + fmt5_array(lr.d[bs, ss]) + "\n")
    else:
        bs = np.flatnonzero(~na)
        ss = lr.closest_slot[bs]
        rows = (names_a[bs] + "\t" + leaf_a[ss] + "\t"
                + fmt5_array(lr.closest_d[bs]) + "\n")
    na_b = np.flatnonzero(na)
    if len(na_b):
        na_rows = names_a[na_b] + "\tNA\tNaN\n"
        order = np.argsort(np.concatenate([bs, na_b]), kind="stable")
        rows = np.concatenate([rows, na_rows])[order]
    out.write("".join(rows.tolist()))
    return len(rows)


REPORTS = {
    "multi": {},
    "no_multi": dict(multi=False),
    "filter": dict(no_filter=False),
    "dist_max": dict(dist_max=0.04),
    "no_multi_dist_max": dict(multi=False, dist_max=0.04),
    "filter_dist_max": dict(no_filter=False, dist_max=0.06),
    "summarize": dict(summarize=True),
    "summarize_dist_max": dict(summarize=True, dist_max=0.04),
}


@pytest.mark.parametrize("emit", [None, (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("report", sorted(REPORTS))
@pytest.mark.parametrize("mode", ["hybrid", "event"])
def test_report_rows_byte_identical(world, engines, mode, report, emit):
    cfg = dist.DistConfig(**REPORTS[report])
    eng = engines[mode]
    names = list(world[1])
    _, lr = _fetch(eng, world, "dist_ratio")
    if emit is not None:
        rank, nranks = emit
        lo, hi = rank * len(names) // nranks, (rank + 1) * len(names) // nranks
        lr, names = lr.select(lo, hi), names[lo:hi]
    leaf_names = [f"leaf{i}" for i in range(eng.S)]
    got, want = io.StringIO(), io.StringIO()
    wc_got, wc_want = np.zeros(eng.S), np.zeros(eng.S)
    n = dist._report_rows(lr, names, leaf_names, cfg, got, wc_got)
    assert lr.__dict__["present"] is None             # no grid built
    assert n == _old_report_rows(lr, names, leaf_names, cfg, want, wc_want)
    assert got.getvalue() == want.getvalue()
    assert np.array_equal(wc_got, wc_want)
    if cfg.summarize:
        assert wc_got.sum() > 0
    else:
        assert n == got.getvalue().count("\n") > 0
        if emit is None and math.isnan(cfg.dist_max):
            assert "\tNA\tNaN\n" in got.getvalue()
