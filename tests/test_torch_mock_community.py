"""The ZymoBIOMICS D6300 cell (`zymo_d6300.dist.mock` in BENCHMARK.json) on
the host, at its configuration's own 10 genomes with `genome_bp` cut to
200 kbp: the port's main path for an index of at most 32 leaves ('embed'
bucket rows with the leaf bitmask in the row, one mask word, the
probe_hist_packed epilogue, sparse-row routing, the heavy table whose aux
word is the mask itself). The run agrees with the benchmark's plain
reference; the packed epilogue equals the tiles kernel's plain form on the
same gathered rows; a heavy tail forced through tier B or through capped
re-runs gives the default rows and the reference's; the `heavy_lanes`
counter equals a recount of the resident positions with a bucket deeper
than C0, on its own and in a traced run of the cell; the cell's two new
metrics read nothing on an untraced run.

Imports no JAX, so the card's machine runs the cuda-marked case:
    python -m pytest --noconftest -m cuda tests/test_torch_mock_community.py
"""

import time

import numpy as np
import pytest
import torch

from krepp_tpu_torch.core import trace
from krepp_tpu_torch.core.codec import pad_codes_batch
from krepp_tpu_torch.query import engine as qengine
from krepp_tpu_torch.query import kernels
from krepp_tpu_torch.query.dist import DistConfig, _bucket_len, run_dist
from krepp_tpu_torch.query.engine import QueryEngine
from portbench import check, harness, program, reference, world

torch.set_num_threads(1)

CELL = "zymo_d6300.dist.mock"
SCALE = {"config": {"genome_bp": 200_000},
         "traffic": {"reads": 3000, "check_reads": 96}}
SEED = 2 ** 31 + 11
METRICS = ("packed_roofline_pct", "heavy_lanes_per_read")


@pytest.fixture(scope="module")
def mock(tmp_path_factory):
    """(world, traffic, program, FASTQ of the reads) of the cell at SCALE,
    built on the host as a run of the cell builds it."""
    _, cfg, traffic = harness.cell_spec(harness.benchmark(), CELL)
    cfg = {**cfg, **SCALE["config"]}
    traffic = {**traffic, **SCALE["traffic"]}
    w = harness.make_world(cfg, traffic, SEED, "cpu")
    d = tmp_path_factory.mktemp("mock_community")
    prog = harness.load_program(w, traffic, SEED, "cpu", str(d))
    fastq = str(d / "sample.fq")
    world.write_fastq(fastq, w.reads)
    return w, traffic, prog, fastq


def _dist(eng, fastq):
    """One dist pass of `eng` over the FASTQ: (report, stats)."""
    sink = harness.Sink()
    sink.keep = True
    stats = {}
    run_dist(eng.di, fastq, sink, "inv", DistConfig(hdist_th=eng.th),
             engine_factory=lambda d, th: eng, stats=stats)
    return "".join(sink.kept), stats


def _batch(eng, reads):
    """The reads as one padded batch on the engine's device: (codes [B, L]
    int32, lengths [B] int32)."""
    codes, lengths = pad_codes_batch(list(reads), pad_to=_bucket_len(
        reads.shape[1]))
    dev = eng.device
    return (torch.from_numpy(codes).to(dev, torch.int32),
            torch.from_numpy(lengths).to(dev))


def _heavy_positions(eng, reads) -> np.ndarray:
    """[2, n, P] bool: the reads' resident LSH positions, both strands,
    whose bucket holds more than C0 entries, recounted on the host from the
    index's row offsets (row_start, sorted nonempty row ids)."""
    codes, lengths = _batch(eng, reads)
    rix2, _, valid, _ = eng._strand_hashes(codes, lengths)
    urow, resident = eng._rows(rix2, valid[None])
    di = eng.di
    u = urow.cpu().numpy()
    pos = np.minimum(np.searchsorted(di.row_ids, u), len(di.row_ids) - 1)
    found = resident.cpu().numpy() & (di.row_ids[pos] == u)
    return found & (np.diff(di.row_start)[pos] > eng.C0)


def test_cell_lists_its_metrics():
    """The cell reports every end-to-end metric and, among its per-layer
    metrics, the two it brought (others may list it too)."""
    bench = harness.benchmark()
    assert len(harness.cell_metrics(bench, CELL, "end_to_end")) == len(
        bench["end_to_end"])
    assert set(METRICS) <= {m["name"] for m in harness.cell_metrics(
        bench, CELL, "per_layer")}


def test_engine_takes_the_packed_main_path(mock):
    _, _, prog, _ = mock
    eng = prog.engine
    f = prog.facts
    assert (f["mode"], f["hflavor"], f["W"], f["S"], f["C0"]) == (
        "hybrid", "embed", 1, 10, 2)
    assert eng._packed_epilogue_ok(_bucket_len(150) - eng.lsh.k + 1)
    assert eng.di.row_ids is not None           # sparse rows: routed
    heavy_tab = eng._tables[-1]
    assert heavy_tab is not None and eng.di.max_bucket > eng.C0
    # the one-word tail: each entry's aux word is its leaf mask
    counts = np.diff(eng.di.row_start)
    first = eng.di.row_start[np.flatnonzero(counts > eng.C0)]
    mask = eng.di.se_mask[eng.di.se_v[first]][:, 0]
    assert np.array_equal(heavy_tab[:, 2].numpy().view(np.uint32), mask)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_packed_epilogue_equals_the_tiles_plain_form(mock, device):
    """One batch's gathered rows through the engine's epilogue (the packed
    kernel on the card, its plain form on the host) and through
    probe_hist_tiles' plain form: equal histograms and minima."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    w, _, prog, _ = mock
    eng = prog.engine if device == "cpu" else QueryEngine(
        prog.engine.di, prog.engine.th, device=device)
    slots_d, _, _, row_ids, mask_tab, _ = eng._tables
    codes, lengths = _batch(eng, w.reads[:512])
    rix2, res2, valid, _ = eng._strand_hashes(codes, lengths)
    urow, resident = eng._rows(rix2, valid[None])
    sidx, _, resident = eng._route_rows(row_ids, urow, resident)
    d = slots_d[sidx]
    cnt = torch.where(resident, d[..., 0] & 255, 0)
    light = resident & ~(cnt > eng.C0)
    _, B, P = sidx.shape
    before = (kernels.probe_hist_packed.launches,
              kernels.probe_hist_tiles.launches)
    hist, minall = eng._dense_epilogue(d, mask_tab, res2, light, B, P)
    if device == "cuda":
        torch.cuda.synchronize()
        assert (kernels.probe_hist_packed.launches,
                kernels.probe_hist_tiles.launches) == (before[0] + 1,
                                                       before[1])
    N = 2 * B
    want = kernels.probe_hist_tiles_ref(
        res2.reshape(N, P).cpu(), light.reshape(N, P).cpu(),
        d.reshape(N, P, d.shape[-1]).cpu(), None, eng.th, eng.C0, eng.W,
        eng.S)
    assert torch.equal(hist.cpu(), want[0])
    assert torch.equal(minall.cpu(), want[1])
    assert int(want[0].sum()) > 5 * B           # the reads match


def _tier_b(eng, monkeypatch):
    """The heavy table two entries wide, below the deepest bucket: every
    heavy lane finishes in the tier-B scan loop."""
    monkeypatch.setattr(qengine, "TAIL_UNROLL", 2)
    e = QueryEngine(eng.di, eng.th, device="cpu")
    assert e._tables[-1].shape[1] == 1 + 2 * 2 < 1 + 2 * e.di.max_bucket
    return e


def _capped(eng, monkeypatch):
    """A one-lane heavy-tail cap: batches with heavy lanes re-run."""
    e = QueryEngine(eng.di, eng.th, device="cpu")
    e._heavy_cap_override = 1
    return e


@pytest.mark.parametrize("variant", [_tier_b, _capped],
                         ids=["tier_b", "capped"])
def test_heavy_tail_variants_give_the_reference_rows(mock, monkeypatch,
                                                     variant):
    w, traffic, prog, fastq = mock
    want, _ = _dist(prog.engine, fastq)
    got, stats = _dist(variant(prog.engine, monkeypatch), fastq)
    assert got == want
    if variant is _capped:
        assert sum(stats["escalations"]) > 0
    # the reference over the reads that reach the heavy tail
    idx = np.flatnonzero(_heavy_positions(prog.engine,
                                          w.reads).any(axis=(0, 2)))
    assert len(idx) > 0
    names = [f"r{i}" for i in idx]
    ref = reference.report("dist", torch.from_numpy(w.genomes), w.names,
                           w.nwk, w.reads[idx], names, w.params)
    assert check.compare("dist", got, ref, names) <= traffic["check_limit"]


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_heavy_lanes_counts_the_heavy_positions(mock, on):
    w, _, prog, fastq = mock
    trace.reset()
    if on:
        trace.enable()
    try:
        _, stats = _dist(prog.engine, fastq)
        counts = trace.snapshot()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert sum(stats["escalations"]) == 0
    want = int(_heavy_positions(prog.engine, w.reads).sum()) if on else 0
    assert counts.get("heavy_lanes", 0) == want
    assert want > 0 or not on


@pytest.mark.parametrize("name", METRICS)
def test_new_metrics_read_nothing_untraced(mock, name):
    _, _, prog, fastq = mock
    run = harness.window(prog, fastq, 0.0, harness.Sink())
    assert run.reads == 3000 and run.trace is None
    program._readings.clear()       # no reading kept under a reused id
    assert harness.metric_module(name).read(run) is None


def test_traced_cell_run_is_correct_and_counts_heavy_lanes(mock):
    """One traced run of the cell through the harness's own set-up, window
    and comparison: correct, and the counter's metric (the roofline needs
    the card's trace) equals the recount a read."""
    w, _, prog, _ = mock
    bench = harness.benchmark()
    r = harness.run_cell(bench, CELL, SEED, 0.2, True, "cpu",
                         time.perf_counter(), SCALE)
    assert r["correct"], r["checks"]
    (c,) = r["checks"].values()
    assert 0 <= c["value"] <= c["limit"]
    assert set(r["metrics"]) <= {m["name"] for m in harness.cell_metrics(
        bench, CELL, "per_layer")}
    assert "heavy_lanes_per_read" in r["metrics"]
    want = _heavy_positions(prog.engine, w.reads).sum() / len(w.reads)
    assert r["metrics"]["heavy_lanes_per_read"]["value"] == \
        pytest.approx(want)
