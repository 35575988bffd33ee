"""Both packages at the index sizes krepp is for: worlds of more than 1,000
genomes (bench.py's "1k" parameters: k=29 h=13 w=35 m=4, a balanced tree,
short genomes; it is the leaf count S that stresses the query side, not
the genome length), no bitmask table, so the event probe and lane stage 3.

The built indexes must be equal field for field, the dist TSV and place
jplace of both CLIs byte for byte, the leaf stage's integers equal and its
f64 values within 5e-9. The tier-1 case builds both packages' indexes; the
10,000-leaf case (`slow`) lets the reference query the port's saved native
index, because the reference's own build walks the tree once per node (time
quadratic in the node count) and a single-partial native load does not; it
also holds the port's `--mesh 1x2 --device cpu` to one device.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from krepp_tpu import cli as jcli
from krepp_tpu import testing as jtesting
from krepp_tpu.index.artifact import load_native_device as jload_index
from krepp_tpu.query import engine as jengine
from krepp_tpu_torch import cli, testing
from krepp_tpu_torch.index.artifact import save_native
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.query import engine

torch.set_num_threads(1)

TOL = 5e-9
LSH = dict(k=29, h=13, w=35, m=4)     # bench.py CONFIGS["1k"]
NREADS = 384


def _fields_equal(a, b, path=""):
    """Dataclasses (BuiltIndex, ColorTable, FlatTree, params) equal field
    for field; arrays with their dtypes."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        where = f"{path}.{f.name}"
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, where
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), where
        elif dataclasses.is_dataclass(x):
            _fields_equal(x, y, where)
        elif f.name != "tree":
            assert x == y, where


def _write_reads(d, genomes, seed):
    codes = testing.sample_read_codes(np.random.default_rng(seed), genomes,
                                      NREADS, rlen=150, mut=0.05)
    testing.write_fastq(str(d / "q.fq"), codes)
    return codes


def _both_clis(d, *args):
    """One command through both CLIs in this process (the same sys.argv,
    so the same invocation line); returns (reference's, port's) bytes."""
    outs = []
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        out = d / f"{args[0]}_{len(outs)}"
        assert main([*args, "-q", str(d / "q.fq"), "-i", str(d / "idx"),
                     "-o", str(out), *extra]) == 0
        outs.append(out.read_bytes())
    return outs


def _leaf_stage_equal(jdi, codes):
    """The leaf stage of both engines on one batch: integers equal, f64
    within TOL; returns the port's outputs."""
    lengths = np.full(len(codes), codes.shape[1], np.int32)
    je = jengine.QueryEngine(jdi, hdist_th=4)
    te = engine.QueryEngine(DeviceIndex.from_reference(jdi), hdist_th=4,
                            device="cpu")
    assert je.mode == te.mode == "event" and te.S == jdi.nleafslots
    want = je.fetch_leaf_stage(je.run_leaf_stage_async(codes, lengths),
                               lengths, codes=codes)
    got = te.fetch_leaf_stage(te.run_leaf_stage_async(codes, lengths),
                              lengths, codes=codes)
    for f in ("present", "hist", "match", "closest_slot", "onmers", "d",
              "v", "uc", "rho", "closest_d", "hist_closest", "uc_closest",
              "rho_closest", "v_closest", "ratio"):
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            ok = np.isfinite(a) & np.isfinite(b)
            assert np.array_equal(np.isnan(a), np.isnan(b)), f
            assert np.array_equal(a[~ok & ~np.isnan(a)],
                                  b[~ok & ~np.isnan(b)]), f
            assert np.allclose(a[ok], b[ok], rtol=TOL, atol=TOL), f
        else:
            assert np.array_equal(a, b), f
    return got


def _queries_equal(d, jdi, codes):
    """dist and place through both CLIs byte for byte, and the leaf
    stage."""
    got = _leaf_stage_equal(jdi, codes[:128])
    assert got.present.sum(axis=1).max() > 1
    want, have = _both_clis(d, "dist")
    assert have == want and have.count(b"\n") > NREADS
    want, have = _both_clis(d, "place")
    assert have == want and have.count(b'"n" : [') > NREADS // 2
    return have


def test_2048_genomes_through_both_packages(tmp_path):
    """2,048 genomes x 250 bp: both builds equal, both CLIs byte for byte,
    the leaf stage equal (sized for the Tier-1 run: most of the test's
    time is the reference's build, quadratic in the tree)."""
    cfg = dict(seed=41, nleaves=2048, glen=250, rate=0.05, **LSH)
    jbuilt, genomes, _ = jtesting.build_world_index(**cfg)
    built, tgenomes, _ = testing.build_world_index(**cfg, num_threads=4)
    assert sorted(genomes) == sorted(tgenomes)
    _fields_equal(jbuilt, built)
    assert built.colors.nse > built.ftree.nnodes + 1   # composite colors
    save_native(built, str(tmp_path / "idx"))
    codes = _write_reads(tmp_path, tgenomes, 42)
    jdi = jload_index(str(tmp_path / "idx"))
    assert jdi.se_mask is None and jdi.nleafslots == 2048
    _queries_equal(tmp_path, jdi, codes)


@pytest.mark.slow
def test_10000_genomes_through_both_packages(tmp_path):
    """10,000 genomes x 300 bp (ROADMAP item 17, S >= 10^4): the port's
    build, queried by both packages from its saved native index; dist and
    place byte for byte, the leaf stage equal, and `--mesh 1x2 --device
    cpu` byte for byte one device's report."""
    cfg = dict(seed=37, nleaves=10000, glen=300, rate=0.05, **LSH)
    built, genomes, _ = testing.build_world_index(**cfg, num_threads=4)
    assert built.ftree.nnodes == 19999
    save_native(built, str(tmp_path / "idx"))
    del built
    codes = _write_reads(tmp_path, genomes, 38)
    jdi = jload_index(str(tmp_path / "idx"))
    assert jdi.se_mask is None and jdi.nleafslots == 10000
    place = _queries_equal(tmp_path, jdi, codes)
    for cmd, one in (("dist", None), ("place", place)):
        out = tmp_path / f"{cmd}_mesh"
        assert cli.main([cmd, "-q", str(tmp_path / "q.fq"), "-i",
                         str(tmp_path / "idx"), "-o", str(out), "--mesh",
                         "1x2", "--device", "cpu"]) == 0
        if one is None:
            one = (tmp_path / "dist_1").read_bytes()
        assert out.read_bytes() == one
