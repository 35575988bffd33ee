"""Port QueryEngine vs krepp_tpu's on the same worlds and reads: the probe
6-tuple (dense, sparse and deep-bucket worlds, heavy-table and CSR tails,
forced capacity overflow), the fused step in every out_mode, and the
overflow escalation in fetch_prefetched. Integers must be equal, f64
within 5e-9."""

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
}

_CACHE = {}


def _world(name):
    if name not in _CACHE:
        built, genomes, _ = jtesting.build_world_index(**WORLDS[name])
        di = JDeviceIndex.from_built(built)
        rng = np.random.default_rng(12)
        codes = jtesting.sample_read_codes(rng, genomes, 32, rlen=150,
                                           mut=0.08)
        codes[0, 30:34] = 4               # N bases
        lengths = np.full(32, 150, np.int32)
        lengths[1] = 97                   # a short read
        _CACHE[name] = (di, codes, lengths)
    return _CACHE[name]


def _engines(name, **overrides):
    di, codes, lengths = _world(name)
    je = jengine.QueryEngine(di, hdist_th=4)
    te = engine.QueryEngine(DeviceIndex.from_reference(di), hdist_th=4,
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
                                       ("deep", 0), ("deep", 1)])
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
    di, _, _ = _world("dense")
    tdi = DeviceIndex.from_reference(di)
    tdi.se_mask = None                    # a many-genome (event) index
    with pytest.raises(NotImplementedError, match="slice 4"):
        engine.QueryEngine(tdi, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 2"):
        engine.QueryEngine(DeviceIndex.from_reference(di), hdist_th=6,
                           device="cpu")
