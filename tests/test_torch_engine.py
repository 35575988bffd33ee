"""Port QueryEngine vs krepp_tpu's on the same worlds and reads: the probe
6-tuple (dense, sparse and deep-bucket worlds; 48-, 80- and 256-leaf
worlds; long reads and hdist_th = 6; heavy-table and CSR tails; CSR mode;
forced capacity overflow), the fused step in every out_mode, and the
overflow escalation in fetch_prefetched. Integers must be equal, f64
within 5e-9. Where the JAX engine can run its Pallas epilogue (interpret
mode), the port is held against both of its forms."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from krepp_tpu import testing as jtesting
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu.query import engine as jengine
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.query import engine
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

TOL = 5e-9

WORLDS = {
    # the world of tests/test_pallas.py::test_probe_epilogue_matches_xla_engine
    "dense": dict(seed=11, nleaves=6, glen=1500, m=2),
    # reference defaults: sparse row ids, binary-searched routing
    "sparse": dict(seed=8, nleaves=16, glen=3000, k=29, h=13, m=4,
                   rate=0.01),
    # a small row space: buckets up to 9 deep
    "deep": dict(seed=9, nleaves=8, glen=12000, k=23, h=7, w=29, m=2,
                 rate=0.02),
    # 33-64 leaves: two mask words, embedded in the bucket rows
    "w48": dict(seed=21, nleaves=48, glen=1200, m=2),
    # 65-256 leaves: color ids in the rows ('se'), three and eight words
    "w80": dict(seed=22, nleaves=80, glen=800, m=2),
    "w256": dict(seed=23, nleaves=256, glen=400, m=2),
    # 80 leaves over a small row space: deep buckets at W = 3
    "deep80": dict(seed=24, nleaves=80, glen=2500, k=23, h=7, w=29, m=2,
                   rate=0.02),
}

_CACHE = {}


def _world(name, rlen=150):
    if (name, rlen) not in _CACHE:
        built, genomes, _ = jtesting.build_world_index(**WORLDS[name])
        di = JDeviceIndex.from_built(built)
        rng = np.random.default_rng(12)
        codes = jtesting.sample_read_codes(rng, genomes, 32, rlen=rlen,
                                           mut=0.08)
        codes[0, 30:34] = 4               # N bases
        lengths = np.full(32, rlen, np.int32)
        lengths[1] = 97                   # a short read
        _CACHE[name, rlen] = (di, codes, lengths)
    return _CACHE[name, rlen]


def _engines(name, th=4, rlen=150, **overrides):
    di, codes, lengths = _world(name, rlen)
    je = jengine.QueryEngine(di, hdist_th=th)
    te = engine.QueryEngine(DeviceIndex.from_reference(di), hdist_th=th,
                            device="cpu")
    for k, v in overrides.items():
        setattr(je, k, v)
        setattr(te, k, v)
    return je, te, codes, lengths


def _jax_probe(je, codes, lengths, exact=False, tier=0):
    fn = jax.jit(lambda t, c, l: je._probe_impl(t, c, l, exact, tier))
    return jax.device_get(tuple(fn(je._tables, jnp.asarray(codes),
                                   jnp.asarray(lengths))))


def _torch_probe(te, codes, lengths, exact=False, tier=0):
    out = te._probe_impl(te._tables,
                         torch.from_numpy(codes.astype(np.int32)),
                         torch.from_numpy(lengths), exact, tier)
    return tuple(t.numpy() for t in out)


def _assert_tuple_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if a.dtype.kind == "f":
            ok = np.isfinite(a) & np.isfinite(b)
            assert np.array_equal(np.isnan(a), np.isnan(b)), i
            assert np.array_equal(a[~ok & ~np.isnan(a)],
                                  b[~ok & ~np.isnan(b)]), i
            assert np.allclose(a[ok], b[ok], rtol=TOL, atol=TOL), i
        elif a.dtype == np.uint32 or b.dtype == np.uint32:
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), i
        else:
            assert np.array_equal(a, b), i


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_probe_matches_reference(name):
    je, te, codes, lengths = _engines(name)
    assert te.mode == je.mode == "hybrid" and te.hflavor == "embed"
    assert (te._tables[3] is not None) == (name == "sparse")
    got = _torch_probe(te, codes, lengths)
    _assert_tuple_equal(_jax_probe(je, codes, lengths), got)
    assert got[0].sum() > 0 and (got[2] < 255).any()
    if name == "dense":
        # the Pallas epilogue (interpret mode) gives the same tuple
        je._use_pallas = True
        _assert_tuple_equal(_jax_probe(je, codes, lengths), got)


@pytest.mark.parametrize("tail", ["heavy_table", "csr"])
def test_probe_deep_buckets_match_reference(tail, monkeypatch):
    """A 4-wide tail under 9-deep buckets runs the tier-B scan loop."""
    monkeypatch.setattr(jengine, "TAIL_UNROLL", 4)
    monkeypatch.setattr(engine, "TAIL_UNROLL", 4)
    if tail == "csr":
        monkeypatch.setattr(jengine.QueryEngine, "HEAVY_TAB_CAP", 0)
        monkeypatch.setattr(engine, "HEAVY_TAB_CAP", 0)
    je, te, codes, lengths = _engines("deep")
    assert te.di.max_bucket > 4
    assert (te._tables[5] is None) == (tail == "csr")
    _assert_tuple_equal(_jax_probe(je, codes, lengths),
                        _torch_probe(te, codes, lengths))


@pytest.mark.parametrize("name,tier", [("dense", 0), ("sparse", 0),
                                       ("deep", 0), ("deep", 1),
                                       ("w80", 0), ("deep80", 0),
                                       ("deep80", 1)])
def test_probe_with_tiny_heavy_caps_matches_reference(name, tier):
    je, te, codes, lengths = _engines(name, _heavy_cap_override=1)
    want = _jax_probe(je, codes, lengths, tier=tier)
    got = _torch_probe(te, codes, lengths, tier=tier)
    _assert_tuple_equal(want, got)
    if tier == 0:
        assert bool(got[5])               # the cap forces an overflow


def test_exact_probe_matches_reference():
    je, te, codes, lengths = _engines("deep")
    got = _torch_probe(te, codes, lengths, exact=True)
    _assert_tuple_equal(_jax_probe(je, codes, lengths, exact=True), got)
    # the exact scan agrees with the capacity-bounded probe
    _assert_tuple_equal(_torch_probe(te, codes, lengths)[:5], got[:5])


@pytest.mark.parametrize("out_mode", ["dist", "dist_ratio", "full"])
def test_full_step_matches_reference(out_mode):
    je, te, codes, lengths = _engines("dense")
    want = jax.device_get(tuple(je.run_leaf_stage_async(
        codes, lengths, out_mode=out_mode)))
    got = te.run_leaf_stage_async(codes, lengths, out_mode=out_mode).get()
    _assert_tuple_equal(want, got)
    assert int(np.max(got[-1])) == 0


def test_fetch_with_overflow_escalates_like_reference():
    je, te, codes, lengths = _engines("deep", _heavy_cap_override=8,
                                      _lane_cap_override=16)
    want = je.fetch_leaf_stage(
        je.run_leaf_stage_async(codes, lengths, out_mode="dist"), lengths,
        codes=codes, out_mode="dist")
    got = te.fetch_leaf_stage(
        te.run_leaf_stage_async(codes, lengths, out_mode="dist"), lengths,
        codes=codes, out_mode="dist")
    assert te.escalations > 0
    for f in ("present", "d", "closest_slot", "closest_d", "hist", "v",
              "match", "uc", "rho", "hist_closest", "uc_closest",
              "rho_closest", "v_closest", "ratio", "onmers"):
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _assert_tuple_equal((a,), (b,))


def test_unported_layouts_raise():
    """An index without bitmasks (a many-genome index) runs in event mode
    and matches the reference's leaf stage; hdist_th = 6 runs, through the
    tiles epilogue, as the reference."""
    import dataclasses

    di, codes, lengths = _world("dense")
    jdi = dataclasses.replace(di, se_mask=None)
    je = jengine.QueryEngine(jdi, hdist_th=4)
    te = engine.QueryEngine(DeviceIndex.from_reference(jdi), device="cpu")
    assert te.mode == je.mode == "event"
    want = jax.device_get(tuple(je.run_leaf_stage_async(codes, lengths)))
    got = te.run_leaf_stage_async(codes, lengths).get()
    _assert_tuple_equal(want, got)
    assert got[0].any() and int(got[-1]) == 0
    je, te, codes, lengths = _engines("dense", th=6)
    assert not te._packed_epilogue_ok(codes.shape[1] - te.lsh.k + 1)
    _assert_tuple_equal(_jax_probe(je, codes, lengths),
                        _torch_probe(te, codes, lengths))


def _both_forms(je, te, codes, lengths):
    """The port's probe vs the JAX engine's XLA and Pallas-interpret
    forms; returns the port's tuple."""
    got = _torch_probe(te, codes, lengths)
    for use_pallas in (False, True):
        je._use_pallas = use_pallas
        _assert_tuple_equal(_jax_probe(je, codes, lengths), got)
    assert got[0].sum() > 0 and (got[2] < 255).any()
    return got


@pytest.mark.parametrize("name,flavor,W", [("w48", "embed", 2),
                                           ("w80", "se", 3),
                                           ("w256", "se", 8)])
def test_wide_probe_matches_reference(name, flavor, W):
    je, te, codes, lengths = _engines(name)
    assert te.mode == je.mode == "hybrid"
    assert (te.hflavor, te.W, te.S) == (je.hflavor, je.W, je.S)
    assert te.hflavor == flavor and te.W == W
    _both_forms(je, te, codes, lengths)


@pytest.mark.parametrize("name,rlen,th", [("dense", 300, 4),
                                          ("dense", 150, 6),
                                          ("w80", 300, 6)])
def test_long_reads_and_wide_th_match_reference(name, rlen, th):
    je, te, codes, lengths = _engines(name, th=th, rlen=rlen)
    assert not te._packed_epilogue_ok(codes.shape[1] - te.lsh.k + 1)
    _both_forms(je, te, codes, lengths)


@pytest.mark.parametrize("tail", ["heavy_table", "csr"])
def test_wide_deep_buckets_match_reference(tail, monkeypatch):
    """Deep buckets at W = 3: the heavy table holds se ids and the tail
    gathers their mask words; a 4-wide tail runs the tier-B scan loop."""
    monkeypatch.setattr(jengine, "TAIL_UNROLL", 4)
    monkeypatch.setattr(engine, "TAIL_UNROLL", 4)
    if tail == "csr":
        monkeypatch.setattr(jengine.QueryEngine, "HEAVY_TAB_CAP", 0)
        monkeypatch.setattr(engine, "HEAVY_TAB_CAP", 0)
    # one-hot aggregation of the tail in chunks of 64 lanes
    monkeypatch.setattr(engine, "ONEHOT_ELEMS", 64 * 80 * 5)
    je, te, codes, lengths = _engines("deep80")
    assert te.W == 3 and te.hflavor == "se" and te.di.max_bucket > 4
    assert (te._tables[5] is None) == (tail == "csr")
    _both_forms(je, te, codes, lengths)


def _force_csr_mode(monkeypatch):
    """No bucket-row table fits a zero memory cap: both engines take CSR
    mode (the reference binds the cap as a default argument)."""
    monkeypatch.setattr(engine, "DIRECT_MEM_CAP", 0)
    monkeypatch.setattr(jengine.build_hybrid_slots, "__defaults__", (0, None))


@pytest.mark.parametrize("name,nreads", [("deep", 8), ("w80", 32)])
def test_csr_mode_matches_reference(name, nreads, monkeypatch):
    """W = 1 and W = 3, buckets deeper than phase 1: the top-k tail runs
    and does not overflow, so it equals the exact scan."""
    _force_csr_mode(monkeypatch)
    je, te, codes, lengths = _engines(name)
    codes, lengths = codes[:nreads], lengths[:nreads]
    assert te.mode == je.mode == "csr" and te.di.max_bucket > 4
    got = _torch_probe(te, codes, lengths)
    _assert_tuple_equal(_jax_probe(je, codes, lengths), got)
    assert got[0].sum() > 0 and not bool(got[5])
    exact = _torch_probe(te, codes, lengths, exact=True)
    _assert_tuple_equal(_jax_probe(je, codes, lengths, exact=True), exact)
    _assert_tuple_equal(got[:5], exact[:5])


def test_csr_mode_overflow_matches_reference(monkeypatch):
    """25-deep buckets overflow the 128-probe top-k tail of 32 reads; the
    tail picks the same K probes as lax.top_k."""
    _force_csr_mode(monkeypatch)
    je, te, codes, lengths = _engines("deep80")
    got = _torch_probe(te, codes, lengths)
    _assert_tuple_equal(_jax_probe(je, codes, lengths), got)
    assert bool(got[5])


@pytest.mark.parametrize("name,rlen", [("w256", 150), ("dense", 400)])
def test_full_step_at_width_matches_reference(name, rlen):
    """Stage 2 and the scatter-back at S = 256, and on 400-bp reads."""
    je, te, codes, lengths = _engines(name, rlen=rlen)
    want = jax.device_get(tuple(je.run_leaf_stage_async(
        codes, lengths, out_mode="full")))
    got = te.run_leaf_stage_async(codes, lengths, out_mode="full").get()
    _assert_tuple_equal(want, got)
    assert got[0].any() and int(np.max(got[-1])) == 0


def test_wide_fetch_with_overflow_escalates_like_reference():
    je, te, codes, lengths = _engines("deep80", _heavy_cap_override=8,
                                      _lane_cap_override=16)
    want = je.fetch_leaf_stage(
        je.run_leaf_stage_async(codes, lengths, out_mode="dist"), lengths,
        codes=codes, out_mode="dist")
    got = te.fetch_leaf_stage(
        te.run_leaf_stage_async(codes, lengths, out_mode="dist"), lengths,
        codes=codes, out_mode="dist")
    assert te.escalations > 0
    for f in ("present", "d", "closest_slot", "closest_d", "hist", "ratio",
              "onmers"):
        _assert_tuple_equal((getattr(want, f),), (getattr(got, f),))
