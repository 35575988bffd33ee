"""dist's native row emitter (io/native_rows.py, csrc/dist_rows.c): its
numbers against Python's "%.5f" and `dist._report_rows` against the numpy
object-string rows it replaced, byte for byte, in every report mode."""

import io
import math

import numpy as np
import pytest

from krepp_tpu_torch.io.native_rows import dist_rows
from krepp_tpu_torch.query import dist
from krepp_tpu_torch.query.engine import DistLanes, LeafResults
from krepp_tpu_torch.reports import fmt5_array


def _ties(n):
    """Odd multiples of 1/64 (the only doubles exactly halfway at five
    decimals) and their neighbours on both sides."""
    t = (2.0 * np.arange(n) + 1.0) / 64.0
    return np.concatenate([t, np.nextafter(t, 0.0), np.nextafter(t, np.inf)])


EDGES = [0.0, -0.0, 5e-6, np.nextafter(5e-6, 0.0), 0.999995, 1e6,
         np.nextafter(1e6, 0.0), 1e17, 1e300, np.inf, -np.inf, np.nan,
         -np.nan, -0.3, -1e-9, 4.5e10, 2.0 ** 40, 5e-324, 1e-300,
         99999.999995, np.nextafter(99999.999995, np.inf),
         -np.finfo(np.float64).max, np.finfo(np.float64).max]


def _decimal_halves(rng):
    """The doubles nearest to decimal ties (m + 0.5) / 1e5, where d * 1e5
    may round onto the tie: below 0.3, and up to 1e5."""
    m = np.concatenate([rng.integers(0, 30_000, 15_000),
                        rng.integers(0, 10 ** 10, 15_000)])
    return (2.0 * m + 1.0) / 2e5


VALUES = {
    "decimal_halves": _decimal_halves,
    "uniform_0_0.3": lambda rng: rng.random(40_000) * 0.3,
    "uniform_0_1e6": lambda rng: rng.random(30_000) * 1e6,
    "log_uniform": lambda rng: 10.0 ** rng.uniform(-12, 12, 30_000),
    "ties": lambda rng: _ties(64 * 300),
    "edges": lambda rng: np.array(EDGES, np.float64),
}


@pytest.mark.parametrize("family", sorted(VALUES))
def test_numbers_equal_python_percent_format(family):
    vals = VALUES[family](np.random.default_rng(len(family)))
    n = len(vals)
    text, rows = dist_rows(["r"], ["L"], np.zeros(1, bool),
                           np.zeros(n, np.int64), np.zeros(n, np.int64), vals)
    got = [ln.split("\t")[2] for ln in text.split("\n")[:-1]]
    want = ["nan" if math.isnan(x) else "%.5f" % x for x in vals.tolist()]
    assert rows == n == len(got)
    assert got == want


def test_number_families_cover_a_hundred_thousand_values():
    rng = np.random.default_rng(0)
    assert sum(len(f(rng)) for f in VALUES.values()) >= 100_000


def _numpy_report_rows(lr, names, leaf_names, cfg, out, wcount):
    """dist._report_rows as numpy object strings wrote the rows."""
    B = len(names)
    lanes = lr.lanes
    lb, ls, ld = lanes.b, lanes.s, lanes.d
    dist_max = cfg.dist_max
    no_dmax = math.isnan(dist_max)
    names_a = np.asarray(names, dtype=object)
    if cfg.summarize:
        sel = lanes.ratio < cfg.chisq_value
        if not no_dmax:
            sel &= ld < dist_max
        bs, ss = lb[sel], ls[sel]
        cnt = np.bincount(bs, minlength=B)
        w = np.zeros(B)
        np.divide(1.0, cnt, out=w, where=cnt > 0)
        np.add.at(wcount, ss, w[bs])
        return 0
    leaf_a = np.asarray(leaf_names, dtype=object)
    na = np.bincount(lb, minlength=B) == 0
    if not no_dmax:
        na |= lr.closest_d > dist_max
    if cfg.multi:
        sel = ~na[lb]
        if not cfg.no_filter:
            sel &= lanes.ratio < cfg.chisq_value
        if not no_dmax:
            sel &= ld < dist_max
        bs = lb[sel]
        rows = (names_a[bs] + "\t" + leaf_a[ls[sel]] + "\t"
                + fmt5_array(ld[sel]) + "\n")
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


def _results(rng, B, S, n_lanes):
    """A lane-form LeafResults of B reads with n_lanes lanes; each read
    with lanes has one of them as its closest slot, the others -1."""
    flat = np.sort(rng.choice(B * S, size=n_lanes, replace=False))
    b, s = np.divmod(flat, S)
    lanes = DistLanes(b, s, rng.random(n_lanes) * 0.12, S,
                      ratio=rng.random(n_lanes) * 5)
    slot = np.full(B, -1, np.int32)
    pick = rng.random(n_lanes)
    for i in np.argsort(pick):
        slot[b[i]] = s[i]
    return LeafResults(
        present=None, d=None, closest_slot=slot,
        closest_d=lanes.at_slot(slot), hist_closest=rng.random((B, 5)),
        uc_closest=rng.random(B), rho_closest=rng.random(B),
        v_closest=rng.random(B), onmers=None,
        lengths=np.full(B, 150, np.int32), lanes=lanes)


def _compare(lr, names, leaf_names, cfg):
    got, want = io.StringIO(), io.StringIO()
    wc_got, wc_want = np.zeros(len(leaf_names)), np.zeros(len(leaf_names))
    n = dist._report_rows(lr, names, leaf_names, cfg, got, wc_got)
    assert n == _numpy_report_rows(lr, names, leaf_names, cfg, want,
                                   wc_want)
    assert got.getvalue() == want.getvalue()
    assert np.array_equal(wc_got, wc_want)
    if not cfg.summarize:
        assert n == got.getvalue().count("\n")
    return got.getvalue()


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
ROW_REPORTS = sorted(k for k in REPORTS if "summarize" not in k)


@pytest.mark.parametrize("emit", [None, (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("report", sorted(REPORTS))
def test_rows_equal_the_numpy_rows(report, emit):
    """The report modes and emit_slice ranges of
    test_torch_dist_lanes.test_report_rows_byte_identical, on a random
    batch of 300 reads over 40 leaves."""
    rng = np.random.default_rng(len(report) * 7 + (emit or (5, 0))[0])
    B, S = 300, 40
    lr = _results(rng, B, S, 520)
    names = [f"read{i}/1" for i in range(B)]
    if emit is not None:
        rank, nranks = emit
        lo, hi = rank * B // nranks, (rank + 1) * B // nranks
        lr, names = lr.select(lo, hi), names[lo:hi]
    text = _compare(lr, names, [f"leaf{i}" for i in range(S)],
                    dist.DistConfig(**REPORTS[report]))
    if report == "multi":
        assert "\tNA\tNaN\n" in text and text.count("\n") > len(names)


def _case(name, rng):
    """(LeafResults, read names, leaf names) of each edge batch."""
    S = 12
    leaves = [f"leaf{i}" for i in range(S)]
    if name == "non_ascii":
        B = 30
        names = [f"réad_{i}_读取_🧬" for i in range(B)]
        leaves = [f"Ĝenome_{i}_基因组" for i in range(S)]
        return _results(rng, B, S, 50), names, leaves
    if name == "names_255_bytes":
        B = 25
        names = [("r%d" % i).ljust(255, "x") for i in range(B - 1)]
        names.append("é" * 127 + "x")               # 255 UTF-8 bytes
        leaves = [("L%d" % i).ljust(255, "y") for i in range(S)]
        assert len(names[-1].encode()) == 255
        return _results(rng, B, S, 60), names, leaves
    if name == "no_reads":
        return _results(rng, 0, S, 0), [], leaves
    if name == "all_na":
        B = 17
        return _results(rng, B, S, 0), [f"q{i}" for i in range(B)], leaves
    if name == "lanes_equal_reads":
        B = 23
        return (_results(rng, B, S, B), [f"q{i}" for i in range(B)],
                leaves)
    B = 40
    lr = _results(rng, B, S, 90)
    if name == "nan_distance":
        lr.lanes.d[[0, 7, 40]] = np.nan
    elif name == "huge_distance":
        # the widest numbers, on one-byte names: the buffer's bound
        lr.lanes.d[:] = 1e300
        lr.lanes.d[::3] = -np.finfo(np.float64).max
        lr.lanes.d[1::7] = np.inf
        names = [chr(ord("a") + i % 26) for i in range(B)]
        leaves = [chr(ord("A") + i) for i in range(S)]
        lr.closest_d = lr.lanes.at_slot(lr.closest_slot)
        return lr, names, leaves
    lr.closest_d = lr.lanes.at_slot(lr.closest_slot)
    return lr, [f"q{i}" for i in range(B)], leaves


CASES = ("non_ascii", "names_255_bytes", "no_reads", "all_na",
         "lanes_equal_reads", "nan_distance", "huge_distance")


@pytest.mark.parametrize("report", ROW_REPORTS)
@pytest.mark.parametrize("case", CASES)
def test_edge_batches_equal_the_numpy_rows(case, report):
    lr, names, leaves = _case(case, np.random.default_rng(len(case)))
    text = _compare(lr, names, leaves, dist.DistConfig(**REPORTS[report]))
    if case == "all_na":
        assert text.count("\tNA\tNaN\n") == len(names) > 0
    if case == "no_reads":
        assert text == ""
    if case == "huge_distance" and report == "multi":
        assert "\t" + "%.5f" % -np.finfo(np.float64).max + "\n" in text


def test_rows_out_of_read_order_raise():
    na = np.zeros(3, bool)
    d = np.full(2, 0.1)
    with pytest.raises(ValueError, match="out of read order"):
        dist_rows(["a", "b", "c"], ["L"], na, np.array([2, 1]),
                  np.zeros(2, np.int64), d)
    with pytest.raises(ValueError, match="out of range"):
        dist_rows(["a", "b", "c"], ["L"], na, np.array([0, 1]),
                  np.array([0, -1]), d)


def test_a_name_with_a_newline_raises():
    with pytest.raises(ValueError, match="newline"):
        dist_rows(["a\nb"], ["L"], np.ones(1, bool), np.zeros(0, np.int64),
                  np.zeros(0, np.int64), np.zeros(0))
