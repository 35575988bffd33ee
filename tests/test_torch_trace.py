"""The port's span-and-counter registry (krepp_tpu_torch/core/trace.py) on
the host: off, it makes nothing; on, spans nest and count self time per
thread, batches number their spans, the counters agree with what the run
returned and with the full-mode outputs, dist builds no [B, S] view, spans
annotate torch.profiler's trace, the sharded engine's cell threads keep
their own stacks and count what the one-device engine counts, reports do
not change, and the CLI's --trace-dir writes spans.json."""

import io
import json
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from krepp_tpu_torch import cli
from krepp_tpu_torch.core import host_turn, trace
from krepp_tpu_torch.index import artifact
from krepp_tpu_torch.index.build import build_index
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.params import IndexParams, LSHParams
from krepp_tpu_torch.parallel.mesh import ShardedQueryEngine, make_query_mesh
from krepp_tpu_torch.query import engine as qengine
from krepp_tpu_torch.query.dist import DistConfig, _bucket_len, run_dist
from krepp_tpu_torch.query.engine import QueryEngine
from krepp_tpu_torch.query.place import PlaceConfig, run_place
from krepp_tpu_torch.io.fastx import QueryBatcher
from krepp_tpu_torch.core.codec import pad_codes_batch
from krepp_tpu_torch.tree.newick import Tree

import worldgen

torch.set_num_threads(1)

# the spans the engine and the entries open
STEP = ("hash", "probe", "lanes", "stage2", "stage3", "outputs")
PROGRAM = ("entry", "prep", "upload", "sync", "wait", "fetch",
           "report") + STEP
# three batches of 150 bp reads, so some are in flight
BATCH_BP = 16 * 150


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 16-leaf world from FASTA (tests/worldgen.py), its index and 42
    reads (two of them random)."""
    rng = np.random.default_rng(16)
    d = tmp_path_factory.mktemp("torch_trace_world")
    nwk, genomes = worldgen.make_world(rng, nleaves=16, glen=1500, rate=0.05)
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
    artifact.save_native(built, str(d / "idx"))
    reads = worldgen.sample_reads(rng, genomes, n=40, mut=0.04)
    qpath = d / "q.fq"
    with open(qpath, "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    return DeviceIndex.from_built(built), str(qpath), d


@pytest.fixture
def traced():
    """The registry on and empty for the test; off and empty after it."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _dist(di, qpath, engine=None, **cfg):
    out = io.StringIO()
    stats = {}
    n = run_dist(di, qpath, out, "inv",
                 DistConfig(batch_bp=BATCH_BP, **cfg), device="cpu",
                 stats=stats,
                 engine_factory=None if engine is None
                 else (lambda d, th: engine))
    return n, out.getvalue(), stats


def _place(di, qpath, engine=None, **cfg):
    out = io.StringIO()
    stats = {}
    n = run_place(di, qpath, out, "inv",
                  PlaceConfig(batch_bp=BATCH_BP, **cfg), device="cpu",
                  stats=stats,
                  engine_factory=None if engine is None
                  else (lambda d, th: engine))
    return n, out.getvalue(), stats


def _data_lines(text):
    """The report's rows: neither comments nor the column header."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith(("#", "SEQ_ID\t"))]


def _present_lanes(di, qpath):
    """The present (read, leaf) lanes of the full-mode outputs of the
    batches run_dist makes of qpath."""
    eng = QueryEngine(di, 4, device="cpu")
    total = 0
    for _, seqs in QueryBatcher(qpath, bp_limit=BATCH_BP):
        codes, lengths = pad_codes_batch(
            seqs, pad_to=_bucket_len(max(len(s) for s in seqs)))
        lr = eng.fetch_leaf_stage(eng.run_leaf_stage_async(codes, lengths),
                                  lengths, codes=codes)
        total += int(lr.present.sum())
    return total


def _self_ns(records):
    """Self time of each record, by id, from the records alone."""
    child = Counter()
    for name, t0, t1, rid, parent, bid, tid in records:
        if parent is not None:
            child[parent] += t1 - t0
    return {r[3]: r[2] - r[1] - child[r[3]] for r in records}


# ----------------------------------------------------------------- off
def test_off_makes_no_record_counter_or_annotation(world):
    di, qpath, _ = world
    trace.reset()
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b") is trace.span("sync")
    assert trace.batch(3) is trace.span("a")
    assert trace.new_batch() is None and trace.take_device(None) is None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _dist(di, qpath)
        _place(di, qpath)
    names = {e.name for e in prof.events()}
    assert not names & set(PROGRAM)
    snap = trace.snapshot()
    assert snap["records"] == [] and snap["counts"] == {}
    assert snap["spans"] == {} and snap["dropped"] == 0


# ------------------------------------------------------------------ on
def test_nesting_self_time_and_batches(traced):
    with trace.span("outer"):
        time.sleep(0.02)
        bid = trace.new_batch()
        with trace.span("inner"):
            time.sleep(0.03)
            with trace.batch(None), trace.span("free"):
                pass
    with trace.batch(bid), trace.span("later"):
        pass
    assert trace.new_batch() == bid + 1 and bid == 0
    snap = trace.snapshot()
    recs = {r[0]: r for r in snap["records"]}
    assert [r[0] for r in snap["records"]] == ["free", "inner", "outer",
                                                 "later"]
    assert recs["outer"][4] is None
    assert recs["inner"][4] == recs["outer"][3]
    assert recs["free"][4] == recs["inner"][3]
    assert recs["later"][4] is None
    # a span belongs to the batch current on its thread when it ends
    assert [recs[n][5] for n in ("free", "inner", "outer", "later")] == [
        None, 0, 0, 0]
    assert len({r[6] for r in snap["records"]}) == 1
    selfs = _self_ns(snap["records"])
    for name in recs:
        assert snap["spans"][name] == pytest.approx(
            selfs[recs[name][3]] * 1e-9)
    assert snap["spans"]["inner"] == pytest.approx(0.03, abs=0.02)
    assert snap["spans"]["outer"] == pytest.approx(0.02, abs=0.015)
    inner = recs["inner"]
    assert snap["spans"]["outer"] * 1e9 == pytest.approx(
        recs["outer"][2] - recs["outer"][1] - (inner[2] - inner[1]))


def test_a_sync_point_counts_once(traced):
    t = torch.tensor([7])
    assert host_turn.host_int(t) == 7
    host_turn.host_wait(t.device)
    snap = trace.snapshot()
    assert snap["counts"]["host_syncs"] == 2
    assert [r[0] for r in snap["records"]] == ["sync", "sync"]


def test_dist_counters_agree_with_the_run(world, traced):
    di, qpath, _ = world
    n, text, stats = _dist(di, qpath)
    snap = trace.snapshot()
    c = snap["counts"]
    assert n == 42 and stats["batches"] == 3
    assert c["reads"] == n and c["batches"] == stats["batches"]
    assert c["rows"] == len(_data_lines(text))
    assert c["kmer_positions"] == 42 * (150 - 27 + 1)
    assert c["stage2_lanes"] == _present_lanes(di, qpath) > 42
    assert 0 < c["matched_positions"] <= c["kmer_positions"]
    assert "h2d_bytes" not in c and "d2h_bytes" not in c   # nothing copied
    # the spans of each batch carry its number
    by_batch = Counter((r[0], r[5]) for r in snap["records"])
    for b in range(3):
        for name in ("upload", "wait", "fetch", "report", "stage2"):
            assert by_batch[name, b] == 1, (name, b)
    assert by_batch["prep", 2] == 2            # the last, empty read too
    assert by_batch["entry", None] == 1
    assert set(snap["spans"]) <= set(PROGRAM)
    assert snap["spans"].keys() >= {"entry", "prep", "upload", "hash",
                                    "probe", "lanes", "stage2", "outputs",
                                    "wait", "fetch", "report"}
    assert snap["launches"].keys() == set(trace.KERNELS)


@pytest.mark.parametrize("reads_a_batch", [16, 14])
def test_one_reader_call_a_batch(world, traced, reads_a_batch):
    """The query batcher makes one native reader call a batch
    (`fastx_batch_calls`), also where the input ends on a batch's last
    read (42 reads in batches of 14)."""
    di, qpath, _ = world
    stats = {}
    n = run_dist(di, qpath, io.StringIO(), "inv",
                 DistConfig(batch_bp=reads_a_batch * 150), device="cpu",
                 stats=stats)
    c = trace.snapshot()["counts"]
    assert n == 42 and stats["batches"] == 3
    assert c["fastx_batch_calls"] == c["batches"] == stats["batches"]


def test_benchmark_prep_wrappers_cover_the_reading_and_padding(world):
    """portbench's `prep` wrappers (metrics/prep_ms_per_kread.SPANS)
    install over dist and place, time every native batch read and every
    padded batch inside a `prep` span, and leave the reports unchanged."""
    from portbench.metrics import prep_ms_per_kread
    from portbench.spans import Spans

    from krepp_tpu_torch.core import codec
    from krepp_tpu_torch.io import fastx
    from krepp_tpu_torch.query import dist, place

    di, qpath, _ = world

    def runs():
        return (_dist(di, qpath)[1], _place(di, qpath)[1],
                _place(di, qpath, tabular=True)[1])

    want = runs()
    spans = Spans()
    inside = []
    read_batches, pad_rows = fastx.read_batches, codec.pad_rows

    def reading(*args):
        for item in read_batches(*args):
            inside.append(("read", bool(spans._stack)))
            yield item

    def padding(*args):
        inside.append(("pad", bool(spans._stack)))
        return pad_rows(*args)

    originals = [dist.QueryBatcher, place.QueryBatcher,
                 dist.pad_codes_batch, codec.pad_codes_batch]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fastx, "read_batches", reading)
        mp.setattr(codec, "pad_rows", padding)
        spans.install(prep_ms_per_kread.SPANS)
        try:
            assert [dist.QueryBatcher, place.QueryBatcher,
                    dist.pad_codes_batch, codec.pad_codes_batch] != originals
            spans.active = True
            got = runs()
        finally:
            spans.uninstall()
    assert [dist.QueryBatcher, place.QueryBatcher, dist.pad_codes_batch,
            codec.pad_codes_batch] == originals
    assert got == want
    assert spans.totals["prep"] > 0 and set(spans.totals) == {"prep"}
    assert Counter(inside) == {("read", True): 9, ("pad", True): 9}


DIST_OPTS = {"default": {}, "filter": dict(no_filter=False),
             "summarize": dict(summarize=True)}


@pytest.mark.parametrize("opts", sorted(DIST_OPTS))
def test_dist_builds_no_dense_view(world, traced, opts):
    """dist's fetch and report read the lanes alone: no [B, S] view is
    built, and no batch re-runs."""
    di, qpath, _ = world
    _, text, stats = _dist(di, qpath, **DIST_OPTS[opts])
    c = trace.snapshot()["counts"]
    assert stats["escalations"] == [0, 0, 0]
    assert c["stage2_lanes"] > 42 and "dense_views" not in c
    assert c["rows"] > 0 and text.count("\n") > c["rows"]


@pytest.mark.parametrize("opts", sorted(DIST_OPTS))
def test_one_row_emitter_call_a_batch(world, traced, opts):
    """dist writes a batch's rows with one native call
    (`dist_emit_calls`); summarize writes no per-read rows and makes
    none."""
    di, qpath, _ = world
    _, text, stats = _dist(di, qpath, **DIST_OPTS[opts])
    c = trace.snapshot()["counts"]
    assert stats["batches"] == c["batches"] == 3
    if "summarize" in DIST_OPTS[opts]:
        assert "dist_emit_calls" not in c
    else:
        assert c["dist_emit_calls"] == c["batches"]
        assert c["rows"] == len(_data_lines(text)) > 42


@pytest.mark.parametrize("opts", sorted(DIST_OPTS))
def test_dist_rerun_writes_the_same_rows(world, traced, opts):
    """A batch re-run in full (a one-lane stage-2 cap) gives its lanes
    from the dense outputs: the same report."""
    di, qpath, _ = world
    want = _dist(di, qpath, **DIST_OPTS[opts])[1]
    eng = QueryEngine(di, 4, device="cpu")
    eng._lane_cap_override = 1
    _, got, stats = _dist(di, qpath, engine=eng, **DIST_OPTS[opts])
    assert min(stats["escalations"]) > 0
    assert got == want and len(_data_lines(got)) > 0
    assert "dense_views" not in trace.snapshot()["counts"]


def test_place_counters_agree_with_the_run(world, traced):
    di, qpath, _ = world
    n, text, stats = _place(di, qpath, tabular=True)
    c = trace.snapshot()["counts"]
    assert c["reads"] == n == 42 and c["batches"] == stats["batches"] == 3
    assert c["rows"] == len(_data_lines(text)) > 0
    assert c["stage2_lanes"] == _present_lanes(di, qpath)
    assert c["place_candidates"] > 0


@pytest.mark.parametrize("formulation", ["dense", "lanes"])
def test_place_spans_and_jplace_rows(world, traced, formulation,
                                     monkeypatch):
    di, qpath, _ = world
    if formulation == "lanes":
        from krepp_tpu_torch.query import place

        monkeypatch.setattr(place, "DENSE_AGG_MAX", 0)
    _, text, stats = _place(di, qpath)
    assert stats["formulation"] == formulation
    snap = trace.snapshot()
    doc = json.loads(text)
    assert snap["counts"]["rows"] == sum(len(p["p"])
                                         for p in doc["placements"])
    assert "stage3" in snap["spans"] and "fetch" not in snap["spans"]


def test_spans_annotate_the_profiler(world, traced):
    di, qpath, d = world
    from torch.profiler import ProfilerActivity, profile

    # a lane cap too small for any batch: each re-runs inside its fetch, so
    # spans nest
    eng = QueryEngine(di, 4, device="cpu")
    eng._lane_cap_override = 8
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _dist(di, qpath, engine=eng)
    assert eng.escalations > 0
    path = str(d / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        notes = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and e["name"] in PROGRAM]
    recs = trace.snapshot()["records"]
    assert Counter(e["name"] for e in notes) == Counter(r[0] for r in recs)
    # the k-th record of a name is the k-th annotation of that name
    ann = {}
    for name in {r[0] for r in recs}:
        rs = sorted((r for r in recs if r[0] == name), key=lambda r: r[1])
        es = sorted((e for e in notes if e["name"] == name),
                    key=lambda e: e["ts"])
        ann.update({r[3]: e for r, e in zip(rs, es)})
    nested = 0
    for r in recs:
        if r[4] is not None:
            e, p = ann[r[3]], ann[r[4]]
            assert p["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                           <= p["ts"] + p["dur"] + 1)
            nested += 1
    assert nested > 0


@pytest.mark.parametrize("mode", ["hybrid", "event"])
def test_sharded_threads_keep_their_stacks(world, traced, mode, monkeypatch):
    di, qpath, _ = world
    if mode == "event":
        monkeypatch.setattr(qengine, "FORCE_EVENT", True)
    single = QueryEngine(di, 4, device="cpu")
    sharded = ShardedQueryEngine(di, make_query_mesh(2, 2, device="cpu"), 4)
    assert sharded.concurrent and sharded.mode == single.mode
    counts = []
    for eng in (single, sharded):
        trace.reset()
        _dist(di, qpath, engine=eng)
        _place(di, qpath, engine=eng, tabular=True)
        snap = trace.snapshot()
        counts.append(snap["counts"])
    recs = snap["records"]
    thread_of = {r[3]: r[6] for r in recs}
    assert len(set(thread_of.values())) > 1    # cell threads opened spans
    for r in recs:
        if r[4] is not None:
            assert thread_of[r[4]] == r[6]
    # every span of a step, on any thread, belongs to a numbered batch
    assert all(r[5] is not None for r in recs if r[0] in STEP)
    work = ("reads", "batches", "kmer_positions", "stage2_lanes",
            "matched_positions", "rows", "place_candidates")
    assert {k: counts[1][k] for k in work} == {k: counts[0][k] for k in work}


def test_reports_do_not_change_with_tracing(world):
    di, qpath, _ = world
    runs = []
    for on in (False, True):
        trace.reset()
        (trace.enable if on else trace.disable)()
        try:
            runs.append((_dist(di, qpath)[1], _place(di, qpath)[1],
                         _place(di, qpath, tabular=True)[1]))
        finally:
            trace.disable()
    trace.reset()
    assert runs[0] == runs[1]


def test_cli_trace_dir_writes_spans(world, tmp_path, capsys):
    _, qpath, d = world
    tdir = tmp_path / "tr"
    assert cli.main(["--verbose", "--trace-dir", str(tdir), "dist", "-q",
                     qpath, "-i", str(d / "idx"), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert not trace.enabled()
    with open(tdir / "spans.json") as f:
        snap = json.load(f)
    assert snap["counts"]["reads"] == 42 and snap["records"]
    assert {"upload", "stage2", "report"} <= set(snap["spans"])
    lines = err.splitlines()
    stats = next(i for i, ln in enumerate(lines)
                 if ln.startswith("dist stats: "))
    got = json.loads(next(ln for ln in lines[stats:]
                          if ln.startswith("trace: "))[len("trace: "):])
    assert got["counts"] == snap["counts"]
    trace.reset()


def test_records_stop_at_the_cap(traced, monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 2)
    for _ in range(5):
        with trace.span("a"):
            pass
    snap = trace.snapshot()
    assert len(snap["records"]) == 2 and snap["dropped"] == 3
    assert snap["spans"]["a"] > 0


def test_device_counts_ride_with_the_outputs(traced):
    trace.count_device("x", torch.tensor(3))
    trace.count_device("x", torch.tensor([4.0]))
    trace.count_device("y", torch.tensor(5, dtype=torch.int32))
    pend = qengine._Pending((torch.arange(2),), torch.device("cpu"))
    assert trace.take_device(torch.device("cpu")) is None
    (out,) = pend.get()
    assert out.tolist() == [0, 1]
    assert trace.snapshot()["counts"] == {"x": 7, "y": 5}


def test_threads_count_exactly(traced):
    """More threads than cores, switching often: no count or record is
    lost, and no span finds another thread's parent."""
    def work():
        for _ in range(300):
            trace.count("n")
            with trace.span("s"):
                trace.count_device("d", torch.tensor(1))

    n = 2 * (os.cpu_count() or 4)
    threads = [threading.Thread(target=work) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    names, values = trace.take_device(torch.device("cpu"))
    assert len(names) == 300 * n and int(values.sum()) == 300 * n
    snap = trace.snapshot()
    assert snap["counts"]["n"] == 300 * n
    assert len(snap["records"]) == 300 * n
    assert all(r[4] is None for r in snap["records"])
