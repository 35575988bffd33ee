"""The port's own copies of krepp_tpu's host modules (params, stdrand,
reports, tree, colors, hll, sdust, native_sort, native_colorize, and
the small helpers of index.artifact; its save / load functions are held
equal on whole directories in test_torch_cli_index.py), and the port's
genome reader (io.fastx over io.native_batch) against krepp_tpu's
io.native: the same numpy-seeded inputs through the original and the
port, exact equality (these are integer and string functions; fmt5 output
compared as strings).
"""

import dataclasses
import gzip
import math

import numpy as np
import pytest

from krepp_tpu import params as jparams
from krepp_tpu import reports as jreports
from krepp_tpu.core import hll as jhll
from krepp_tpu.core import native_colorize as jcolorize
from krepp_tpu.core import native_sort as jsort
from krepp_tpu.core import sdust as jsdust
from krepp_tpu.core import stdrand as jstdrand
from krepp_tpu.index import colors as jcolors
from krepp_tpu.io.native import read_fastx_native as jread_fastx_native
from krepp_tpu.testing import make_world
from krepp_tpu.tree import flat as jflat
from krepp_tpu.tree import newick as jnewick
from krepp_tpu_torch import params, reports
from krepp_tpu_torch.core import (hll, native_colorize, native_sort, sdust,
                                  stdrand)
from krepp_tpu_torch.index import colors
from krepp_tpu_torch.io import fastx, native_batch
from krepp_tpu_torch.tree import flat, newick
from refcsrc import private_reference_csrc  # noqa: F401

D_MAX = np.finfo(np.float64).max


# ------------------------------------------------------------------ params
def test_params_defaults_and_constants():
    for name in ("LSHParams", "IndexParams"):
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(jparams, name))]
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(params, name))]
        assert [n for n, _ in want] == [n for n, _ in got]
        for (_, a), (_, b) in zip(want, got):
            assert (a is dataclasses.MISSING) == (b is dataclasses.MISSING)
            assert a == b or a is dataclasses.MISSING
    for c in ("RBATCH_SIZE", "DSEQ_LEN", "BATCH_BP_LIMIT"):
        assert getattr(jparams, c) == getattr(params, c)
    for kw in (dict(), dict(k=27, w=40, h=12)):
        for maker in ("index_defaults", "sketch_defaults"):
            a = getattr(jparams.IndexParams, maker)(**kw)
            b = getattr(params.IndexParams, maker)(**kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.k, a.h, a.m, a.nrows_local, a.suffix) == \
                (b.k, b.h, b.m, b.nrows_local, b.suffix)


@pytest.mark.parametrize("k,h,w", [
    (29, 13, 35), (27, 11, 35), (26, 10, 32), (19, 3, 19), (31, 15, 31),
    (29, 13, 28), (29, 2, 35), (29, 16, 35), (32, 16, 40), (18, 4, 30),
    (31, 14, 35), (29, 12, 29)])
def test_validate_lsh_config_table(k, h, w):
    def outcome(fn):
        try:
            fn(k, h, w)
            return None
        except ValueError as e:
            return str(e)

    assert outcome(jparams.validate_lsh_config) == \
        outcome(params.validate_lsh_config)


@pytest.mark.parametrize("k,h,m,seed", [(29, 13, 4, 0), (27, 11, 2, 5),
                                        (26, 10, 4, None), (31, 15, 3, 77)])
def test_lsh_positions_and_stdrand(k, h, m, seed):
    a = jparams.LSHParams.generate(k, h, m, seed=seed)
    b = params.LSHParams.generate(k, h, m, seed=seed)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.nrows_global == b.nrows_global
    ga, gb = jstdrand.MT19937(), stdrand.MT19937()
    if seed is not None:
        ga.seed(seed)
        gb.seed(seed)
    assert [ga() for _ in range(700)] == [gb() for _ in range(700)]
    assert [jstdrand.uniform_int_u32(ga, 0, k - 1) for _ in range(50)] == \
        [stdrand.uniform_int_u32(gb, 0, k - 1) for _ in range(50)]
    with pytest.raises(ValueError):
        params.LSHParams(k=k, h=h, m=m, ppos=a.ppos[:-1], npos=a.npos)


# ----------------------------------------------------------------- reports
def test_fmt5_on_random_values_ties_and_specials():
    rng = np.random.default_rng(11)
    grid = rng.integers(0, 10 ** 6, 200) / 1e5
    x = np.concatenate([
        rng.random(500), rng.random(200) * 1e-6, -rng.random(50),
        rng.standard_normal(100) * 1e4,
        grid + 5e-6, grid - 5e-6, grid,        # ties of the 5-decimal grid
        [0.0, -0.0, 0.5, 0.000005, 0.000015, 1.0, 0.75, math.nan, math.inf,
         -math.inf, D_MAX, -D_MAX, 1e-320]])
    assert [jreports.fmt5(float(v)) for v in x] == \
        [reports.fmt5(float(v)) for v in x]
    want, got = jreports.fmt5_array(x), reports.fmt5_array(x)
    assert want.dtype == got.dtype and list(want) == list(got)
    assert list(got) == [reports.fmt5(float(v)) for v in x]


def test_report_headers_and_jplace_framing():
    inv = "krepp dist -q reads.fq -i idx"
    nwk = "((A:0.10000{0},B:0.20000{1}):0.05000{2});"
    assert reports.REFERENCE_VERSION == jreports.REFERENCE_VERSION
    for s in (False, True):
        assert jreports.dist_header(inv, s) == reports.dist_header(inv, s)
        for t in (False, True):
            assert jreports.place_header(inv, nwk, s, t) == \
                reports.place_header(inv, nwk, s, t)
    assert jreports.seek_header(inv) == reports.seek_header(inv)
    assert jreports.begin_jplace() == reports.begin_jplace()
    assert jreports.end_jplace(inv, 1234, nwk) == \
        reports.end_jplace(inv, 1234, nwk)
    row = (7, 0.01, 0.25, -12.3456789, 0.999995, math.nan)
    assert jreports.jplace_fields(*row) == reports.jplace_fields(*row)
    assert jreports.jukes_cantor(0.1234) == reports.jukes_cantor(0.1234)


# -------------------------------------------------------------------- tree
def _flat_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f.name
        else:
            assert x == y, f.name


def _node_table(tree):
    return [(nd.se, nd.name, nd.is_leaf, nd.card, nd.nchildren,
             nd.eff_nchildren, nd.is_taxon, nd.ldepth,
             None if math.isnan(nd.blen) else nd.blen,
             nd.parent.se if nd.parent is not None else 0)
            for nd in tree.postorder()]


def _pruned(nwk, drop):
    """Newick without the leaves named in drop (unary nodes collapsed)."""
    tree = jnewick.Tree.parse(nwk)

    def prune(nd):
        if nd.is_leaf:
            return None if nd.name in drop else f"{nd.name}:{nd.blen:g}"
        subs = [s for s in (prune(c) for c in nd.children) if s]
        if len(subs) <= 1:
            return subs[0] if subs else None
        return "(" + ",".join(subs) + ")" + (
            "" if math.isnan(nd.blen) else f":{nd.blen:g}")

    s = prune(tree.root)
    return s[: s.rindex(")") + 1] + ";"


@pytest.mark.parametrize("nleaves,seed", [(2, 0), (5, 1), (6, 2), (13, 3),
                                          (48, 4)])
def test_newick_and_flat_on_world_trees(nleaves, seed):
    nwk, _ = make_world(np.random.default_rng(seed), nleaves=nleaves, glen=40)
    jt, tt = jnewick.Tree.parse(nwk), newick.Tree.parse(nwk)
    assert jnewick.Tree.tokenize(nwk) == newick.Tree.tokenize(nwk)
    assert _node_table(jt) == _node_table(tt) and jt.nnodes == tt.nnodes
    for kw in (dict(), dict(jplace=True), dict(fixed5=True),
               dict(jplace=True, fixed5=True)):
        assert jt.newick(**kw) == tt.newick(**kw)
    assert [nd.se for nd in jt.leaves()] == [nd.se for nd in tt.leaves()]
    jf, tf = jflat.FlatTree.from_tree(jt), flat.FlatTree.from_tree(tt)
    _flat_equal(jf, tf)
    assert np.array_equal(jf.leaf_ses(), tf.leaf_ses())
    assert jf.children_lists() == tf.children_lists()
    for se in range(1, jf.nnodes + 1):
        assert jf.clade_leafset(se) == tf.clade_leafset(se)
    la, lb = jt.leaves(), tt.leaves()
    assert jnewick.Tree.distance(la[0], la[-1]) == \
        newick.Tree.distance(lb[0], lb[-1])
    assert jnewick.Tree.lca(la[0], la[-1]).se == \
        newick.Tree.lca(lb[0], lb[-1]).se
    # the tree generated when no backbone is given
    names = [nd.name for nd in la]
    assert _node_table(jnewick.Tree.generate(names)) == \
        _node_table(newick.Tree.generate(names))


def test_map_to_qtree_on_a_pruned_tree_and_placement_weights():
    nwk, _ = make_world(np.random.default_rng(9), nleaves=12, glen=40)
    q_nwk = _pruned(nwk, {"G001", "G007", "G008"})
    outs = []
    for nk, fl in ((jnewick, jflat), (newick, flat)):
        index_tree, qtree = nk.Tree.parse(nwk), nk.Tree.parse(q_nwk)
        se_to_node = nk.map_to_qtree(index_tree, qtree)
        leaf_ses = fl.FlatTree.from_tree(index_tree).leaf_ses()
        leaf_qse = np.array([0 if se_to_node[se] is None else se_to_node[se].se
                             for se in leaf_ses], np.int32)
        qflat = fl.FlatTree.from_tree(qtree)
        outs.append((leaf_qse, qflat, fl.placement_weights(qflat, leaf_qse),
                     index_tree.check_compatible(qtree)))
    (ja, jq, jw, jc), (ta, tq, tw, tc) = outs
    assert np.array_equal(ja, ta) and (ta == 0).sum() == 3
    _flat_equal(jq, tq)
    assert np.array_equal(jw, tw) and tw.sum() > 0 and jc == tc


@pytest.mark.parametrize("qtree", ["index", "pruned", "lineages"])
def test_placement_ancestors_are_the_nonzero_weights(qtree):
    """The port's sparse ancestor chains (the lane path's stage-3 input,
    built without the dense [Q+1, S] grid) hold, for every slot, exactly
    np.flatnonzero of the reference's placement_weights column and its
    values; unmapped slots hold nothing."""
    nwk, _ = make_world(np.random.default_rng(9), nleaves=12, glen=40)
    text = {"index": nwk, "pruned": _pruned(nwk, {"G001", "G007", "G008"}),
            "lineages": "\n".join(
                f"G{i:03d}\td__B;p__P{i % 2};c__C{i % 3};o__O;f__F;"
                f"g__G{i % 4};s__S{i}" for i in range(12) if i != 5)}[qtree]
    outs = []
    for nk, fl in ((jnewick, jflat), (newick, flat)):
        index_tree = nk.Tree.parse(nwk)
        q = (nk.Tree.parse_lineages(text) if qtree == "lineages"
             else nk.Tree.parse(text))
        se_to_node = nk.map_to_qtree(index_tree, q)   # sets eff_nchildren
        leaf_qse = np.array([0 if se_to_node[se] is None
                             else se_to_node[se].se
                             for se in fl.FlatTree.from_tree(
                                 index_tree).leaf_ses()], np.int32)
        outs.append((leaf_qse, fl.FlatTree.from_tree(q)))
    (jq, jflat_q), (leaf_qse, qflat) = outs
    assert np.array_equal(jq, leaf_qse)
    W = jflat.placement_weights(jflat_q, leaf_qse)
    anc_q, anc_w = flat.placement_ancestors(qflat, leaf_qse)
    assert anc_q.dtype == np.int64 and anc_w.dtype == np.float64
    assert anc_q.shape == (len(leaf_qse), max(
        (W[:, s] > 0).sum() for s in range(len(leaf_qse))))
    for s in range(len(leaf_qse)):
        nz = np.flatnonzero(W[:, s] > 0)
        assert np.array_equal(anc_q[s, : len(nz)], nz)
        assert np.array_equal(anc_w[s, : len(nz)], W[nz, s])
        assert not anc_q[s, len(nz):].any() and not anc_w[s, len(nz):].any()
    assert (leaf_qse == 0).sum() == {"index": 0, "pruned": 3,
                                     "lineages": 1}[qtree]


def test_lineage_trees_match():
    text = "\n".join(
        f"G{i:03d}\td__B;p__P{i % 2};c__C{i % 3};o__O;f__F;g__G{i % 4};s__S{i}"
        for i in range(9))
    jt, tt = jnewick.Tree.parse_lineages(text), newick.Tree.parse_lineages(text)
    assert _node_table(jt) == _node_table(tt)
    assert jt.newick() == tt.newick()


def _balanced_newick(nleaves: int) -> str:
    def split(lo, hi):
        if hi - lo == 1:
            return f"G{lo:05d}:0.1"
        mid = (lo + hi) // 2
        return f"({split(lo, mid)},{split(mid, hi)}):0.01"

    return split(0, nleaves).rsplit(":", 1)[0] + ";"


@pytest.mark.parametrize("source", ["world", "lineages"])
def test_clade_leafsets_match_reference(source):
    """Every node's clade set from the port's one post-order pass equals
    the reference's per-node walk: a world tree and a multifurcating
    lineage tree (taxon nodes, unary chains)."""
    if source == "world":
        text, _ = make_world(np.random.default_rng(6), nleaves=37, glen=40)
        jt, tt = jnewick.Tree.parse(text), newick.Tree.parse(text)
    else:
        text = "\n".join(f"G{i:03d}\td__B;p__P{i % 2};c__C{i % 3};o__O;"
                         f"f__F{i % 5};g__G{i % 7};s__S{i}" for i in range(40))
        jt = jnewick.Tree.parse_lineages(text)
        tt = newick.Tree.parse_lineages(text)
    jf, tf = jflat.FlatTree.from_tree(jt), flat.FlatTree.from_tree(tt)
    sets = tf.clade_leafsets()
    assert len(sets) == jf.nnodes + 1 and sets[0] == ()
    for se in range(1, jf.nnodes + 1):
        assert sets[se] == jf.clade_leafset(se)
        assert all(type(x) is int for x in sets[se])
    assert sets[jf.nnodes] == tuple(int(x) for x in jf.leaf_ses())


def test_clade_leafsets_are_linear_in_the_tree(monkeypatch):
    """A 20,000-leaf balanced tree: the port builds its child lists once
    and every clade set in one pass, in seconds (the reference rebuilds
    the child lists on every call, so all clade sets cost it time
    quadratic in the node count); the sets equal the reference's on a
    sample of 200 nodes, each of which costs the reference one pass."""
    import time

    text = _balanced_newick(20000)
    tf = flat.FlatTree.from_tree(newick.Tree.parse(text))
    jf = jflat.FlatTree.from_tree(jnewick.Tree.parse(text))
    built = []
    lists = flat.FlatTree.children_lists
    monkeypatch.setattr(flat.FlatTree, "children_lists",
                        lambda self: built.append(1) or lists(self))
    t0 = time.perf_counter()
    sets = tf.clade_leafsets()
    cb = colors.ColorBuilder(tf)
    cb.finalize(np.zeros(tf.nnodes + 1))
    assert time.perf_counter() - t0 < 60
    assert len(built) == 1 and tf.clade_leafsets() is sets
    assert len(sets[tf.nnodes]) == 20000
    rng = np.random.default_rng(7)
    sample = set(rng.choice(np.arange(1, tf.nnodes + 1), 200,
                            replace=False).tolist())
    sample |= {1, tf.nnodes, int(jf.leaf_ses()[-1])}
    for se in sorted(sample):
        assert sets[se] == jf.clade_leafset(se), se
        assert cb.color_of(sets[se]) == se


# ------------------------------------------------------------------ colors
def test_color_builder_and_table_match():
    nwk, _ = make_world(np.random.default_rng(4), nleaves=11, glen=40)
    rng = np.random.default_rng(5)
    jf = jflat.FlatTree.from_tree(jnewick.Tree.parse(nwk))
    tf = flat.FlatTree.from_tree(newick.Tree.parse(nwk))
    jb, tb = jcolors.ColorBuilder(jf), colors.ColorBuilder(tf)
    leaves = jf.leaf_ses()
    sets = [tuple(sorted(rng.choice(leaves, size=rng.integers(1, 6),
                                    replace=False).tolist()))
            for _ in range(60)] + [jf.clade_leafset(se)
                                   for se in range(1, jf.nnodes + 1)]
    assert [jb.color_of(s) for s in sets] == [tb.color_of(s) for s in sets]
    rho = rng.random(jf.nnodes + 1)
    jc, tc = jb.finalize(rho.copy()), tb.finalize(rho.copy())
    _flat_equal(jc, tc)
    slot = {int(se): i for i, se in enumerate(leaves)}
    assert np.array_equal(jc.leaf_masks(slot, len(leaves)),
                          tc.leaf_masks(slot, len(leaves)))
    for se in (1, jc.nnodes, jc.nse - 1):
        assert np.array_equal(jc.leaves_of(se), tc.leaves_of(se))
    jc.apply_rho_coef(0.5)
    tc.apply_rho_coef(0.5)
    assert np.array_equal(jc.rho, tc.rho)
    # a reference-format decomposition table: composite = union of two ids
    pse = np.zeros((jc.nnodes + 4, 2), np.int64)
    pse[jc.nnodes + 1] = (leaves[0], leaves[3])
    pse[jc.nnodes + 2] = (jc.nnodes + 1, leaves[5])
    pse[jc.nnodes + 3] = (jc.nnodes, jc.nnodes + 2)
    _flat_equal(jcolors.colors_from_pse(jc.nnodes, pse, jf, rho),
                colors.colors_from_pse(tc.nnodes, pse, tf, rho))


# ---------------------------------------------------------- index.artifact
def _index_params(mod, seed, r=1, frac=True):
    return mod.IndexParams(lsh=mod.LSHParams.generate(27, 11, 4, seed=seed),
                           w=35, r=r, frac=frac)


@pytest.mark.parametrize("r,frac", [(1, True), (0, False), (3, False),
                                    (2, True)])
def test_artifact_info_blocks_and_residues_match(r, frac):
    from krepp_tpu.index import artifact as jartifact
    from krepp_tpu_torch.index import artifact

    jp, tp = _index_params(jparams, 5, r, frac), _index_params(params, 5, r,
                                                               frac)
    assert jartifact._fallback_info(jp, 4096, 777) == \
        artifact._fallback_info(tp, 4096, 777)
    meta = {"seed": 5, "nrows": 4096, "nkmers": 777}
    assert jartifact._native_info(meta, jp) == artifact._native_info(meta, tp)
    assert jartifact._native_info({"nrows": 1, "nkmers": 2}, jp) == \
        artifact._native_info({"nrows": 1, "nkmers": 2}, tp)
    assert list(jartifact._partial_residues(jp)) == \
        list(artifact._partial_residues(tp))
    assert jp.suffix == tp.suffix


def test_artifact_directory_scans_and_compatibility_match(tmp_path):
    from krepp_tpu.index import artifact as jartifact
    from krepp_tpu_torch.index import artifact

    for name in ("cmer-m4r1-frac", "inc-m4r1-frac", "metadata-m4r1-frac",
                 "metadata-m4r1-frac.txt", "crecord-m4r0-no_frac",
                 "tree-m4r0-no_frac", "reflist-m4r1-frac", "notes-x",
                 "meta-m4r0-no_frac.json", "meta-m4r1-no_frac.json",
                 "meta.json", "arrays-m4r0-no_frac.npz", "plain"):
        (tmp_path / name).write_bytes(b"")
    want = jartifact._scan_reference_dir(str(tmp_path))
    assert artifact._scan_reference_dir(str(tmp_path)) == want
    assert want == {"-m4r1-frac": {"cmer", "inc", "metadata", "reflist"},
                    "-m4r0-no_frac": {"crecord", "tree"}}
    assert artifact._scan_native_partials(str(tmp_path)) == \
        jartifact._scan_native_partials(str(tmp_path)) == \
        ["-m4r0-no_frac", "-m4r1-no_frac"]
    for mod, art in ((jparams, jartifact), (params, artifact)):
        same = [_index_params(mod, 5, 0, False), _index_params(mod, 5, 1,
                                                               False)]
        art._check_partials_compatible(same)
        with pytest.raises(ValueError, match="Partial libraries have "
                                             "incompatible hash functions!"):
            art._check_partials_compatible(same + [_index_params(mod, 6)])


def test_built_index_dense_inc_matches():
    from krepp_tpu.index.build import BuiltIndex as JBuiltIndex
    from krepp_tpu_torch.index.build import BuiltIndex

    rng = np.random.default_rng(12)
    jp, tp = _index_params(jparams, 5), _index_params(params, 5)
    rows = np.sort(rng.integers(0, jp.nrows_local, 500)).astype(np.int64)
    kw = dict(tree=None, names=[], enc_v=np.zeros(500, np.uint32),
              se_v=np.zeros(500, np.int32), colors=None, ftree=None)
    want = JBuiltIndex(params=jp, inc=None, rows_local=rows, **kw).dense_inc()
    got = BuiltIndex(params=tp, inc=None, rows_local=rows, **kw).dense_inc()
    assert want.dtype == got.dtype and np.array_equal(want, got)
    assert len(got) == tp.nrows_local and got[-1] == 500
    assert BuiltIndex(params=tp, inc=got, **kw).dense_inc() is got


# --------------------------------------------------------------------- hll
def test_hyperloglog_matches():
    rng = np.random.default_rng(6)
    for b, n in ((12, 50000), (4, 300), (12, 0), (14, 1000)):
        h = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        ja, ta = jhll.HyperLogLog(b), hll.HyperLogLog(b)
        ja.add_many(h)
        ta.add_many(h)
        assert np.array_equal(ja.M, ta.M) and ja.estimate() == ta.estimate()
        jb_, tb_ = jhll.HyperLogLog(b), hll.HyperLogLog(b)
        jb_.add_many(h[::2] ^ np.uint32(12345))
        tb_.add_many(h[::2] ^ np.uint32(12345))
        ja.merge(jb_)
        ta.merge(tb_)
        assert np.array_equal(ja.M, ta.M) and ja.estimate() == ta.estimate()
    assert hll.HLL_B == 12
    with pytest.raises(ValueError):
        hll.HyperLogLog(3)


# ------------------------------------------------------------------- sdust
@pytest.mark.parametrize("T,W", [(20, 64), (10, 32), (28, 64)])
def test_sdust_intervals_match(T, W):
    rng = np.random.default_rng(T + W)
    codes = rng.integers(0, 4, 6000).astype(np.uint8)
    for _ in range(8):       # planted homopolymers, tandem repeats, N runs
        at = int(rng.integers(0, 5800))
        unit = rng.integers(0, 4, int(rng.integers(1, 6))).astype(np.uint8)
        run = int(rng.integers(20, 160))
        codes[at: at + run] = np.resize(unit, run)[: len(codes) - at]
    codes[rng.integers(0, 6000, 12)] = 4
    codes[3000:3040] = 4
    want, got = jsdust.sdust(codes, T, W), sdust.sdust(codes, T, W)
    assert want == got and len(got) >= 3
    assert all(0 <= s < f <= 6000 for s, f in got)
    assert sdust.sdust(codes[:2], T, W) == jsdust.sdust(codes[:2], T, W)
    with open(jsdust.__file__) as f, open(sdust.__file__) as g:
        theirs, ours = f.read(), g.read()
    assert ours.replace(
        "\nThe port's own copy of krepp_tpu/core/sdust.py: the port imports"
        "\nnothing of the JAX package, so it carries the host code it needs."
        "\n", "") == theirs


# ------------------------------------------------------------- native sort
@pytest.mark.parametrize("n", [0, 1, 7, 1001, (1 << 16) + 13])
def test_native_sort_functions_match(n):
    rng = np.random.default_rng(n)
    # few distinct keys: duplicates, and runs that test stability
    keys = rng.integers(0, max(2, n // 3), n).astype(np.uint64) << np.uint64(29)
    vals = np.arange(n, dtype=np.uint32)
    for a, b in zip(jsort.sort_kv(keys, vals), native_sort.sort_kv(keys, vals)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jsort.sort_k(keys), native_sort.sort_k(keys))
    rows = rng.integers(0, 50, n).astype(np.uint32)
    res = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    res[: n // 2] = res[n // 2: n // 2 + n // 2]          # duplicate pairs
    rows[: n // 2] = rows[n // 2: n // 2 + n // 2]
    want, got = jsort.pack_keys(rows, res), native_sort.pack_keys(rows, res)
    assert want.dtype == got.dtype and np.array_equal(want, got)
    for a, b in zip(jsort.sort_unique_pairs(rows, res),
                    native_sort.sort_unique_pairs(rows, res)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    r2, s2 = rows.copy(), res.copy()
    for a, b in zip(jsort.sort_unique_pairs(rows, res),
                    native_sort.sort_unique_pairs(r2, s2, inplace=True)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("B,L,with_n", [(1, 1, False), (5, 150, False),
                                        (7, 33, True), (3, 192, True),
                                        (0, 16, False)])
def test_native_pack_codes_matches(B, L, with_n):
    rng = np.random.default_rng(B * 1000 + L)
    codes = rng.integers(0, 5 if with_n else 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    want = jsort.pack_codes(codes, lengths)
    got = native_sort.pack_codes(codes, lengths)
    assert np.array_equal(want[0], got[0])
    assert (want[1] is None) == (got[1] is None)
    if want[1] is not None:
        assert np.array_equal(want[1], got[1])


# --------------------------------------------------------- native colorize
@pytest.mark.parametrize("ng,W", [(1, 1), (40, 1), (300, 2), (57, 8)])
def test_native_colorize_matches(ng, W):
    rng = np.random.default_rng(ng + W)
    sizes = rng.integers(1, 6, ng)
    sizes[rng.random(ng) < 0.4] = 1                      # uniform groups
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    leaf = np.concatenate([np.sort(rng.choice(min(64 * W, 40), size=s,
                                              replace=False))
                           for s in sizes]).astype(np.int32)
    (jse, jmask), (tse, tmask) = (jcolorize.color_groups(starts, leaf, W),
                                  native_colorize.color_groups(starts, leaf,
                                                               W))
    assert np.array_equal(jse, tse) and np.array_equal(jmask, tmask)
    assert tmask.shape[1] == W and (tse[sizes == 1] >= 0).all()


# ------------------------------------------------------- the genome reader
def _fasta(rng, n):
    recs = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGTNacgtRY"),
                                 size=rng.integers(1, 400)))
        lines = [seq[j: j + 60] for j in range(0, len(seq), 60)]
        recs.append(f">seq{i} some description\n" + "\n".join(lines) + "\n")
    return "".join(recs)


def _fastq(rng, n):
    recs = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGTN"), size=rng.integers(1, 300)))
        recs.append(f"@read{i}/1 x\n{seq}\n+\n{'I' * len(seq)}\n")
    return "".join(recs)


def _contigs(rng, n):
    """n short FASTA records with one 3 Mbp contig (80-column lines, '\r'
    line ends) in their middle."""
    alpha = np.frombuffer(b"ACGTNacgt", np.uint8)
    long = alpha[rng.integers(0, len(alpha), 3_000_000)].tobytes().decode()
    body = "\r\n".join(long[j: j + 80] for j in range(0, len(long), 80))
    short = _fasta(rng, n - 1)
    mid = short.index(">seq28 ")
    return short[:mid] + f">chr1 3 Mbp\r\n{body}\r\n" + short[mid:]


@pytest.mark.parametrize("kind", ["fasta", "fastq", "contigs"])
@pytest.mark.parametrize("gz", [False, True])
def test_native_fastx_reader_matches(tmp_path, monkeypatch, kind, gz):
    """read_genome_codes yields krepp_tpu's native records' codes, also
    where a call's bases split the records into many calls."""
    rng = np.random.default_rng(len(kind) + gz)
    make = {"fasta": _fasta, "fastq": _fastq, "contigs": _contigs}[kind]
    text = make(rng, 57)
    path = tmp_path / (f"x.{kind}" + (".gz" if gz else ""))
    if gz:
        with gzip.open(path, "wt", compresslevel=1) as f:
            f.write(text)
    else:
        path.write_text(text)
    want = [c for _, c in jread_fastx_native(str(path))]
    got = list(fastx.read_genome_codes(str(path)))
    assert len(want) == len(got) == 57
    assert max(map(len, got)) == (3_000_000 if kind == "contigs" else
                                  max(map(len, want)))
    for jc, tc in zip(want, got):
        assert jc.dtype == tc.dtype and np.array_equal(jc, tc)
    # small calls: records split across reader calls
    calls = []

    def batches(path, bp_limit, counter):
        assert (bp_limit, counter) == (1 << 10, None)
        for names, reads in native_batch._batches(path, bp_limit, counter):
            calls.append(len(names))
            yield names, reads

    monkeypatch.setattr(fastx, "GENOME_BP_A_CALL", 1 << 10)
    monkeypatch.setattr(fastx, "_batches", batches)
    small = list(fastx.read_genome_codes(str(path)))
    assert len(calls) > 2 and sum(calls) == 57
    assert len(small) == 57 and all(
        np.array_equal(a, b) for a, b in zip(small, got))
    with pytest.raises(FileNotFoundError):
        list(fastx.read_genome_codes(str(tmp_path / "missing.fa")))
    bad = tmp_path / "bad.txt"
    bad.write_text("not a sequence file\n")
    with pytest.raises(ValueError):
        list(fastx.read_genome_codes(str(bad)))
