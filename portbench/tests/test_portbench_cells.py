"""Every cell's configuration and traffic through the harness's set-up,
window and comparison at a tiny size on the host: the program's report
agrees with the plain reference."""

from __future__ import annotations

from portbench import control, harness, world

from .conftest import TINY, bench, tiny_run


def test_cell_runs_correct(cell):
    b = bench()
    r = tiny_run(cell)
    assert r["correct"], r["checks"]
    (check,) = r["checks"].values()
    assert 0 <= check["value"] <= check["limit"]
    assert r["attempted"] >= 3000 and r["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(b, cell, "end_to_end")}
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"


def test_traced_run_reads_per_layer_metrics(cell):
    r = tiny_run(cell, trace=True)
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in harness.cell_metrics(bench(), cell,
                                                      "per_layer")}
    got = set(r["metrics"])
    assert got <= listed
    # on the host no kernel runs: only the spans and counters read
    host = {"prep_ms_per_kread", "wait_ms_per_kread", "report_ms_per_kread",
            "reruns_per_batch"}
    assert host & listed <= got
    if "fetch_ms_per_kread" in listed:
        assert "fetch_ms_per_kread" in got
    assert r["metrics"]["prep_ms_per_kread"]["value"] > 0
    assert "breakdown" in r and "busy_s" in r["device"]


def test_place_mix_agrees_with_reference(tmp_path):
    """place_skim, which no cell runs yet (PERF.md, Open questions), on
    refs1k at the tiny size through the harness's own set-up, window and
    comparison: the program's placements agree with the reference's, and
    the float32 control does not."""
    cfg = {**harness.load_json(harness.HERE, "configs", "refs1k.json"),
           **TINY["config"]}
    traffic = {**harness.load_json(harness.HERE, "traffic",
                                   "place_skim.json"), **TINY["traffic"]}
    seed = 2 ** 31 + 9
    w = harness.make_world(cfg, traffic, seed, "cpu")
    prog = harness.load_program(w, traffic, seed, "cpu", str(tmp_path))
    fastq = str(tmp_path / "sample.fq")
    world.write_fastq(fastq, w.reads)
    sink = harness.Sink()
    run = harness.window(prog, fastq, 0.2, sink)
    assert run.reads >= 3000 and run.batches
    gap = harness.reference_gap(w, traffic, "".join(sink.kept), seed, "cpu")
    assert 0 <= gap <= traffic["check_limit"]
    assert control.control_gap(w, traffic, seed, "cpu") > \
        traffic["check_limit"]
