"""Port `place` vs krepp_tpu's on the same worlds and reads: the placement
view (index tree and a pruned query tree), the dense aggregation API, both
fused stage-3 steps (integers equal, f64 within 5e-9, the first n_cand
candidate lanes equal) with and without capacity escalation, and
`run_place` output byte-identical in jplace, --tabular and --summarize,
multi and no-multi, for both formulations (the lane path forced on small
trees, and picked by the size rule on a 256-leaf world)."""

import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from krepp_tpu import testing as jtesting
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu.query import engine as jengine
from krepp_tpu.query import place as jplace
from krepp_tpu.tree.newick import Tree
from krepp_tpu_torch import cli
from krepp_tpu_torch import testing as ttesting
from krepp_tpu_torch.index.artifact import save_native
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.query import engine, place
from krepp_tpu_torch.testing import write_fastq

from test_torch_engine import _assert_tuple_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLDS = {
    # 8 leaves: a 16-node tree, dense by the size rule
    "w8": dict(seed=31, nleaves=8, glen=1500, m=2, rate=0.06),
    # 48 leaves, two mask words ('embed' rows), dense by the size rule
    "w48": dict(seed=21, nleaves=48, glen=1200, m=2),
    # 256 leaves, eight mask words ('se' rows): 512 x 256 cells, lanes
    "w256": dict(seed=23, nleaves=256, glen=400, m=2),
}
NREADS = 32
_CACHE = {}


def _world(name):
    """(reference DeviceIndex, codes, lengths) of a world, cached."""
    if name not in _CACHE:
        built, genomes, _ = jtesting.build_world_index(**WORLDS[name])
        rng = np.random.default_rng(7)
        codes = jtesting.sample_read_codes(rng, genomes, NREADS, rlen=150,
                                           mut=0.05)
        codes[0, 30:34] = 4               # N bases
        _CACHE[name] = (JDeviceIndex.from_built(built), codes,
                        np.full(NREADS, 150, np.int32))
    return _CACHE[name]


def _pruned_newick(tree, drop):
    """Newick of the index tree without the leaves named in `drop` (unary
    nodes collapsed): a placement tree that leaves some slots unmapped."""
    def prune(nd):
        if nd.is_leaf:
            return None if nd.name in drop else nd.name + (
                "" if np.isnan(nd.blen) else f":{nd.blen:g}")
        subs = [s for s in (prune(c) for c in nd.children) if s]
        if not subs:
            return None
        if len(subs) == 1:
            return subs[0]
        return "(" + ",".join(subs) + ")" + (nd.name or "") + (
            "" if np.isnan(nd.blen) else f":{nd.blen:g}")

    s = prune(tree.root)
    return s[: s.rindex(")") + 1] + ";"


def _qtree(jdi, which):
    if which == "index":
        return None
    names = [jdi.ftree.names[se] for se in jdi.leaf_ses]
    return Tree.parse(_pruned_newick(jdi.tree, set(names[:2])))


def _aggregators(name, cfg_kw=None, lanes=False, qtree="index",
                 monkeypatch=None, **overrides):
    jdi, codes, lengths = _world(name)
    if lanes:
        monkeypatch.setenv("KREPP_PLACE_LANES", "1")
        monkeypatch.setattr(place, "DENSE_AGG_MAX", 0)
    q = _qtree(jdi, qtree)
    je = jengine.QueryEngine(jdi, hdist_th=4)
    te = engine.QueryEngine(DeviceIndex.from_reference(jdi), hdist_th=4,
                            device="cpu")
    for k, v in overrides.items():
        setattr(je, k, v)
        setattr(te, k, v)
    cfg_kw = cfg_kw or {}
    ja = jplace.PlaceAggregator(je, jdi.placement_view(q),
                                jplace.PlaceConfig(**cfg_kw))
    ta = place.PlaceAggregator(te, te.di.placement_view(q),
                               place.PlaceConfig(**cfg_kw))
    assert ta.dense == ja._dense_agg
    return ja, ta, codes, lengths


@pytest.mark.parametrize("qtree", ["index", "pruned"])
def test_placement_view_matches_reference(qtree):
    jdi, _, _ = _world("w8")
    q = _qtree(jdi, qtree)
    want = jdi.placement_view(q)
    got = DeviceIndex.from_reference(jdi).placement_view(q)
    for f in ("leaf_qse", "weights", "candidate_ok"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f
    for f in ("parent", "blen", "card", "eff_nchildren", "is_taxon"):
        np.testing.assert_array_equal(getattr(want.qflat, f),
                                      getattr(got.qflat, f))
    assert (got.leaf_qse == 0).sum() == (2 if qtree == "pruned" else 0)


def _compare_step(want, got):
    """13-tuples: per-read outputs and flags equal (f64 within 5e-9); the
    candidate lanes only up to n_cand (the rest is clamped padding)."""
    assert len(want) == len(got) == 13
    _assert_tuple_equal(want[:7] + want[10:], got[:7] + got[10:])
    m = min(int(got[10]), len(got[7]))
    assert int(want[10]) == int(got[10])
    _assert_tuple_equal([a[:m] for a in want[7:10]],
                        [b[:m] for b in got[7:10]])
    return m


def _steps(ja, ta, codes, lengths, tier=0):
    leaf_ok = np.asarray(ta.pv.leaf_qse > 0)
    want = jax.device_get(tuple(ja.run_place_async(codes, lengths, leaf_ok,
                                                   tier=tier)))
    got = ta.run_place_async(codes, lengths, leaf_ok, tier=tier).get()
    return want, got


@pytest.mark.parametrize("name,lanes,qtree", [
    ("w8", False, "index"), ("w8", True, "index"), ("w8", False, "pruned"),
    ("w8", True, "pruned"), ("w48", True, "index"), ("w256", False, "index")])
def test_place_step_matches_reference(name, lanes, qtree, monkeypatch):
    ja, ta, codes, lengths = _aggregators(name, lanes=lanes, qtree=qtree,
                                          monkeypatch=monkeypatch)
    assert ta.dense == (name != "w256" and not lanes)
    want, got = _steps(ja, ta, codes, lengths)
    assert _compare_step(want, got) > 0
    assert not bool(got[-1])


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("cfg", ["no_filter", "no_multi"])
def test_place_step_options_match_reference(lanes, cfg, monkeypatch):
    kw = dict(no_filter=True) if cfg == "no_filter" else dict(multi=False)
    ja, ta, codes, lengths = _aggregators("w8", kw, lanes=lanes,
                                          monkeypatch=monkeypatch)
    assert _compare_step(*_steps(ja, ta, codes, lengths)) > 0


@pytest.mark.parametrize("lanes,cap", [(False, "heavy"), (True, "heavy"),
                                       (False, "lane")])
def test_place_step_after_escalation_matches_reference(lanes, cap,
                                                       monkeypatch):
    """A tiny heavy-tail or lane cap overflows tier 0; tier 1 (exact probe)
    matches too."""
    over = (dict(_heavy_cap_override=1) if cap == "heavy"
            else dict(_lane_cap_override=16))
    ja, ta, codes, lengths = _aggregators("w48", lanes=lanes,
                                          monkeypatch=monkeypatch, **over)
    want, got = _steps(ja, ta, codes, lengths)
    _compare_step(want, got)
    assert bool(got[-1])
    want, got = _steps(ja, ta, codes, lengths, tier=1)
    assert _compare_step(want, got) > 0
    assert not bool(got[-1])


def test_aggregate_and_chisq_match_reference():
    """The dense aggregation API over one LeafResults (the reference's),
    and the host chi-square of every node."""
    ja, ta, codes, lengths = _aggregators("w8")
    lr = ja.engine.run_leaf_stage(codes, lengths)
    want = ja.aggregate(lr)
    got = ta.aggregate(lr)
    _assert_tuple_equal(want, got)
    assert got[5].any()
    args = (got[3], lr.hist_closest, lr.uc_closest, lr.rho_closest,
            lr.v_closest)
    _assert_tuple_equal((ja.chisq_host(*args),), (ta.chisq_host(*args),))


def _fastq(tmp_path, codes):
    path = str(tmp_path / "q.fq")
    write_fastq(path, codes)
    return path


MODES = {
    "jplace": {},
    "no_multi": dict(multi=False),
    "tabular": dict(tabular=True),
    "tabular_no_multi": dict(tabular=True, multi=False),
    "summarize": dict(summarize=True),
    "no_filter": dict(no_filter=True),
}


def _run_both(name, kw, tmp_path, qtree="index", **overrides):
    jdi, codes, _ = _world(name)
    q = _qtree(jdi, qtree)
    qpath = _fastq(tmp_path, codes)
    je = jengine.QueryEngine(jdi, 4)
    te = engine.QueryEngine(DeviceIndex.from_reference(jdi), 4,
                            device="cpu")
    for k, v in overrides.items():
        setattr(je, k, v)
        setattr(te, k, v)
    want = io.StringIO()
    jplace.run_place(jdi, qpath, want, "inv", jplace.PlaceConfig(**kw),
                     qtree=q, engine_factory=lambda di, th: je)
    got = io.StringIO()
    stats = {}
    n = place.run_place(te.di, qpath, got, "inv", place.PlaceConfig(**kw),
                        qtree=q, engine_factory=lambda di, th: te,
                        stats=stats)
    assert n == NREADS
    assert got.getvalue() == want.getvalue()
    return got.getvalue(), stats


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_place_is_byte_identical(mode, lanes, tmp_path, monkeypatch):
    if lanes:
        monkeypatch.setenv("KREPP_PLACE_LANES", "1")
        monkeypatch.setattr(place, "DENSE_AGG_MAX", 0)
    text, stats = _run_both("w8", MODES[mode], tmp_path)
    assert stats["formulation"] == ("lanes" if lanes else "dense")
    assert stats["escalations"] == [0]
    assert len(text.splitlines()) > 10
    if mode in ("jplace", "no_multi", "no_filter"):
        assert len(json.loads(text)["placements"]) > NREADS // 2


@pytest.mark.parametrize("lanes", [False, True])
def test_run_place_on_a_query_tree_is_byte_identical(lanes, tmp_path,
                                                     monkeypatch):
    if lanes:
        monkeypatch.setenv("KREPP_PLACE_LANES", "1")
        monkeypatch.setattr(place, "DENSE_AGG_MAX", 0)
    for mode in ("jplace", "tabular"):
        _run_both("w8", MODES[mode], tmp_path, qtree="pruned")


@pytest.mark.parametrize("name,mode", [("w48", "jplace"),
                                       ("w48", "tabular_no_multi"),
                                       ("w256", "jplace"),
                                       ("w256", "summarize")])
def test_wide_run_place_is_byte_identical(name, mode, tmp_path,
                                          monkeypatch):
    """48 leaves with the lane path forced; 256 leaves, where the size rule
    picks it."""
    if name == "w48":
        monkeypatch.setenv("KREPP_PLACE_LANES", "1")
        monkeypatch.setattr(place, "DENSE_AGG_MAX", 0)
    _, stats = _run_both(name, MODES[mode], tmp_path)
    assert stats["formulation"] == "lanes"
    assert (stats["hflavor"], stats["W"]) == (
        ("embed", 2) if name == "w48" else ("se", 8))


def test_run_place_escalation_is_byte_identical(tmp_path):
    """Every batch overflows a one-lane heavy cap at tier 0 and re-runs at
    tier 1 with the exact probe, as the reference's."""
    _, stats = _run_both("w48", MODES["jplace"], tmp_path,
                         _heavy_cap_override=1)
    assert stats["escalations"] == [1]


def test_report_never_overruns_the_native_rows():
    """A candidate at D_MAX (a leaf without its own hit) prints 315
    characters: the batch goes through the Python rows, which give
    well-formed jplace with the full value."""
    jdi, _, _ = _world("w8")
    pv = DeviceIndex.from_reference(jdi).placement_view(None)
    leaf = int(pv.leaf_qse[0])
    inner = int(pv.qflat.parent[leaf])
    lr = engine.LeafResults(
        present=None, d=None, closest_slot=np.array([0, 0], np.int32),
        closest_d=np.array([0.01, 0.02]),
        hist_closest=np.array([[3.0, 2, 1, 0, 0], [4.0, 0, 0, 0, 0]]),
        uc_closest=np.zeros(2), rho_closest=np.full(2, 0.5),
        v_closest=np.array([10.0, 12.0]), onmers=np.array([100, 100]),
        lengths=np.array([150, 150]))
    cb = np.array([1, 1])
    cq = np.array([inner, leaf])
    cd = np.array([0.03, engine.D_MAX])
    cv = np.array([11.0, 0.0])
    chisq = np.array([0.5, 1.0])
    assert not place._native_fits(place._row_fields(pv.qflat, cq, cd, cv,
                                                    np.ones(2)))
    out = io.StringIO()
    cfg = place.PlaceConfig()
    emitted = place._report_batch(lr, np.array([1, 2]), ["a", "b"], pv, cfg,
                                  out, None, False, cb, cq, cd, cv, chisq)
    assert emitted
    # its pendant length is NaN, which the reference prints as "nan"
    text = out.getvalue().replace("nan", "NaN")
    doc = json.loads("{\"placements\": [\n" + text + "]}")
    rows = {e["n"][0]: e["p"] for e in doc["placements"]}
    assert rows["a"][0][0] == leaf - 1 and rows["a"][0][4] == 1.0
    assert [r[0] for r in rows["b"]] == [inner - 1, leaf - 1]
    assert rows["b"][1][5] == engine.D_MAX
    assert f"{engine.D_MAX:.5f}" in out.getvalue()


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """The w8 world saved as a native index, its reads as FASTQ with
    README-style ids, and a pruned placement tree as Newick."""
    d = tmp_path_factory.mktemp("torch_place_cli")
    built, _, tree = ttesting.build_world_index(**WORLDS["w8"])
    save_native(built, str(d / "idx"))
    _, codes, _ = _world("w8")
    write_fastq(str(d / "q.fq"), codes, prefix="||61435-")
    names = [built.ftree.names[se] for se in built.ftree.leaf_ses()]
    (d / "q.nwk").write_text(_pruned_newick(tree, set(names[:2])))
    return d


def _cli(d, module, *args):
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO}/tests",
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=d,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_place_on_cpu_prints_the_reference_framing(cli_world):
    """tests/test_readme_golden.py::test_jplace_framing's checks."""
    out = _cli(cli_world, "krepp_tpu_torch", "--verbose", "place", "-q",
               "q.fq", "-i", "idx", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["version"] == 3
    assert doc["fields"] == ["edge_num", "pendant_length", "distal_length",
                             "likelihood", "like_weight_ratio", "distance"]
    assert set(doc["metadata"]) == {"software", "version", "repository",
                                    "num_queries", "invocation"}
    assert doc["metadata"]["software"] == "krepp"
    assert int(doc["metadata"]["num_queries"]) == NREADS
    edges = [int(e) for e in re.findall(r"\{(\d+)\}", doc["tree"])]
    assert sorted(edges) == list(range(len(edges)))
    assert doc["tree"].endswith(";")
    assert len(doc["placements"]) > NREADS // 2
    for p in doc["placements"]:
        assert set(p) == {"n", "p"}
        assert len(p["n"]) == 1 and p["n"][0].startswith("||")
        for rowv in p["p"]:
            assert len(rowv) == 6 and isinstance(rowv[0], int)
    assert out.stdout.startswith('{\n\t"version" : 3,\n\t"fields" : '
                                 '["edge_num"')
    assert 'place stats: {"mode": "hybrid"' in out.stderr
    assert '"formulation": "dense"' in out.stderr


@pytest.mark.parametrize("args", [("-t", "q.nwk"), ("-t", "q.nwk",
                                                    "--tabular")])
def test_cli_place_matches_the_reference_cli(cli_world, args):
    """Both packages' CLIs on one index, with a placement tree (-t): the
    same bytes but for the invocation, which names each package's
    entry point."""
    want = _cli(cli_world, "krepp_tpu", "place", "-q", "q.fq", "-i", "idx",
                *args)
    got = _cli(cli_world, "krepp_tpu_torch", "place", "-q", "q.fq", "-i",
               "idx", *args, "--device", "cpu")
    assert want.returncode == 0 and got.returncode == 0, got.stderr

    def masked(text):
        return [ln for ln in text.splitlines() if "invocation" not in ln]

    assert masked(got.stdout) == masked(want.stdout)
    assert len(masked(got.stdout)) > 10


@pytest.mark.parametrize("fmt", [[], ["--tabular"], ["--summarize"]])
def test_cli_place_lineage_matches_the_reference_cli(cli_world, tmp_path,
                                                     fmt):
    """`place -l` (a GTDB-style lineage file as the placement tree, as
    tests/test_cli.py::test_cli_place_lineage writes one) through both
    CLIs in this process, jplace, --tabular and --summarize: the same
    bytes (the same sys.argv, so the same invocation line)."""
    from krepp_tpu.cli import main as jmain
    from krepp_tpu_torch.index.artifact import load_index

    names = sorted(load_index(str(cli_world / "idx")).names)
    lineages = tmp_path / "lineages.txt"
    lineages.write_text("".join(
        f"{n}\tk__Bacteria; p__P; c__C; o__O; "
        f"{'f__A' if i < len(names) // 2 else 'f__B'}; g__G{i % 3}; s__\n"
        for i, n in enumerate(names)))
    outs = []
    for main, extra in ((jmain, []), (cli.main, ["--device", "cpu"])):
        out = tmp_path / f"out{len(outs)}"
        assert main(["place", "-q", str(cli_world / "q.fq"), "-i",
                     str(cli_world / "idx"), "-l", str(lineages), "-o",
                     str(out), *fmt, *extra]) == 0
        outs.append(out.read_text())
    assert outs[1] == outs[0]
    rows = [ln for ln in outs[1].splitlines() if not ln.startswith("#")]
    assert len(rows) > 3
    # the lineage tree, not the index's, is the placement tree
    out = tmp_path / "index_tree"
    assert cli.main(["place", "-q", str(cli_world / "q.fq"), "-i",
                     str(cli_world / "idx"), "-o", str(out), *fmt,
                     "--device", "cpu"]) == 0
    assert out.read_text() != outs[1]


def test_cli_place_validates_like_the_reference(cli_world, capsys):
    """The reference's checks; `--mesh 1x2 --device cpu` places as one
    device does, and a malformed --mesh exits with a message."""
    idx = str(cli_world / "idx")
    q = str(cli_world / "q.fq")
    with pytest.raises(SystemExit, match="tau must be less"):
        cli.main(["place", "-q", q, "-i", idx, "--tau", "5", "--device",
                  "cpu"])
    with pytest.raises(SystemExit, match="DATAxSHARD"):
        cli.main(["place", "-q", q, "-i", idx, "--mesh", "1x", "--device",
                  "cpu"])
    capsys.readouterr()
    outs = []
    for mesh in ([], ["--mesh", "1x2"]):
        assert cli.main(["place", "-q", q, "-i", idx, *mesh, "--device",
                         "cpu"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(json.loads(outs[1])["placements"]) > 5
