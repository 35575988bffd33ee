"""Port event mode (indexes without leaf bitmasks) vs krepp_tpu's on the
same worlds and reads: forced event mode on small bitmask worlds against
the reference's event mode and the port's own hybrid mode (stage-2 lanes
and the leaf stage); the 384-leaf world of tests/test_event_probe.py
(index, leaf stage, dist TSV and place jplace through both CLIs); deep
buckets through the heavy table, the CSR gather and the ultra-deep loop;
capacity escalation; and the three reference faults the port avoids.
Integers must be equal, f64 within 5e-9, output bytes identical."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from krepp_tpu import testing as jtesting
from krepp_tpu.index.build import build_index_from_sources as jbuild
from krepp_tpu.index.index import MASK_W_CAP
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu.params import IndexParams, LSHParams
from krepp_tpu.query import engine as jengine
from krepp_tpu.query import event_probe as jevent
from krepp_tpu.tree.newick import Tree
from krepp_tpu_torch import cli
from krepp_tpu_torch.core.codec import seq_to_codes
from krepp_tpu_torch.index.artifact import save_native
from krepp_tpu_torch.index.build import build_index_from_sources
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.query import engine, event_probe

from test_torch_engine import _assert_tuple_equal
from test_torch_index import _assert_device_index_equal

import worldgen
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLDS = {
    # m = 2: every residue resident, no resident-lane compaction
    "dense": (dict(seed=11, nleaves=6, glen=1500, m=2), 32),
    # m = 4, 96 reads: the resident-lane compaction is active
    "m4": (dict(seed=5, nleaves=12, glen=3000, m=4), 96),
    # 80 leaves over a small row space: buckets 25 deep
    "deep80": (dict(seed=24, nleaves=80, glen=2500, k=23, h=7, w=29, m=2,
                    rate=0.02), 32),
}
LEAF_FIELDS = ("present", "d", "closest_slot", "closest_d", "hist", "v",
               "match", "uc", "rho", "hist_closest", "uc_closest",
               "rho_closest", "v_closest", "ratio", "onmers")
_CACHE = {}


def _world(name):
    if name not in _CACHE:
        kw, nreads = WORLDS[name]
        built, genomes, _ = jtesting.build_world_index(**kw)
        rng = np.random.default_rng(12)
        codes = jtesting.sample_read_codes(rng, genomes, nreads, rlen=150,
                                           mut=0.08)
        codes[0, 30:34] = 4               # N bases
        lengths = np.full(nreads, 150, np.int32)
        lengths[1] = 97                   # a short read
        _CACHE[name] = (JDeviceIndex.from_built(built), codes, lengths)
    return _CACHE[name]


def _engines(name, monkeypatch):
    """(reference event engine, port event engine, port hybrid engine,
    codes, lengths) on a bitmask world with event mode forced."""
    jdi, codes, lengths = _world(name)
    monkeypatch.setenv("KREPP_EVENT_PROBE", "1")
    je = jengine.QueryEngine(jdi, hdist_th=4)
    monkeypatch.delenv("KREPP_EVENT_PROBE")
    monkeypatch.setattr(engine, "FORCE_EVENT", True)
    te = engine.QueryEngine(DeviceIndex.from_reference(jdi), 4, device="cpu")
    monkeypatch.setattr(engine, "FORCE_EVENT", False)
    th = engine.QueryEngine(DeviceIndex.from_reference(jdi), 4, device="cpu")
    assert (je.mode, te.mode, th.mode) == ("event", "event", "hybrid")
    return je, te, th, codes, lengths


def _leaf_stage(te, codes, lengths, out_mode="full"):
    return te.fetch_leaf_stage(
        te.run_leaf_stage_async(codes, lengths, out_mode=out_mode), lengths,
        codes=codes, out_mode=out_mode)


def _assert_leaf_equal(want, got, fields=LEAF_FIELDS):
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _assert_tuple_equal((a,), (b,))


def _lanes(te, codes, lengths):
    L, onmers, ov = te._probe_and_lanes(
        te._tables, torch.from_numpy(codes.astype(np.int32)),
        torch.from_numpy(lengths), torch.ones(te.S, dtype=torch.bool), None,
        False, 0)
    return {k: v.numpy() for k, v in L.items()}, onmers.numpy(), ov.numpy()


@pytest.mark.parametrize("name", ["dense", "m4"])
def test_forced_event_matches_reference_and_hybrid(name, monkeypatch):
    je, te, th, codes, lengths = _engines(name, monkeypatch)
    Np = 2 * codes.shape[0] * (codes.shape[1] - te.lsh.k + 1)
    assert (te._resident_cap(Np, 0) is not None) == (name == "m4")
    fn = jax.jit(lambda t, c, l, ok: je._probe_and_lanes(t, c, l, ok, None,
                                                        False, 0))
    want = jax.device_get(fn(je._tables, jnp.asarray(codes),
                             jnp.asarray(lengths), jnp.ones(je.S, bool)))
    got = _lanes(te, codes, lengths)
    hyb = _lanes(th, codes, lengths)
    for k in got[0]:
        _assert_tuple_equal((want[0][k],), (got[0][k],))
        _assert_tuple_equal((hyb[0][k],), (got[0][k],))
    _assert_tuple_equal(want[1:], got[1:])
    assert got[0]["present_l"].sum() > 0 and not got[2]
    lr = _leaf_stage(te, codes, lengths)
    _assert_leaf_equal(je.run_leaf_stage(codes, lengths), lr)
    _assert_leaf_equal(_leaf_stage(th, codes, lengths), lr)
    assert te.escalations == 0


@pytest.mark.parametrize("tail", ["heavy_table", "csr", "csr_deep"])
def test_deep_buckets_match_reference_and_hybrid(tail, monkeypatch):
    """25-deep buckets: the heavy table (16 wide) and, past it, the E-slot
    loop; the CSR gather (24 wide, the loop for the last entry); the CSR
    gather cut to 8 wide, the loop for the rest, which overflows a tier-0
    capacity and escalates."""
    if tail != "heavy_table":
        monkeypatch.setattr(jengine.QueryEngine, "HEAVY_TAB_CAP", 0)
        monkeypatch.setattr(engine, "HEAVY_TAB_CAP", 0)
    if tail == "csr_deep":
        monkeypatch.setattr(jevent, "EVENT_TAIL_UNROLL", 8)
        monkeypatch.setattr(event_probe, "EVENT_TAIL_UNROLL", 8)
    je, te, th, codes, lengths = _engines("deep80", monkeypatch)
    heavy_tab = te._tables[-1]
    assert (heavy_tab is None) == (tail != "heavy_table")
    if heavy_tab is not None:
        assert (heavy_tab.shape[1] - 1) // 2 < te.di.max_bucket == 25
    want = jax.device_get(tuple(je.run_leaf_stage_async(codes, lengths)))
    got = te.run_leaf_stage_async(codes, lengths).get()
    _assert_tuple_equal(want, got)
    assert int(got[-1]) == (tail == "csr_deep")
    lr = _leaf_stage(te, codes, lengths)
    assert te.escalations == (tail == "csr_deep")
    _assert_leaf_equal(je.run_leaf_stage(codes, lengths), lr)
    _assert_leaf_equal(_leaf_stage(th, codes, lengths), lr)
    assert lr.present.sum() > 0


def _tiny_leaf_events(monkeypatch):
    """A 64-slot leaf-event capacity at tier 0 in both engines."""
    for cls in (jengine.QueryEngine, engine.QueryEngine):
        orig = cls._event_caps

        def caps(self, B, P, tier, orig=orig):
            E, KH, CAP_L = orig(self, B, P, tier)
            return (E, KH, 64) if tier == 0 else (E, KH, CAP_L)

        monkeypatch.setattr(cls, "_event_caps", caps)


@pytest.mark.parametrize("cap,out_mode", [("events", "full"),
                                          ("events", "dist"),
                                          ("lanes", "full")])
def test_escalation_matches_reference(cap, out_mode, monkeypatch):
    """A tiny leaf-event cap recovers at tier 1, as the reference's; a
    one-lane stage-2 cap exhausts the tiers and takes the uncapped
    (lane_exact) re-run, which gives the reference's uncapped result."""
    je, te, th, codes, lengths = _engines("dense", monkeypatch)
    if cap == "events":
        _tiny_leaf_events(monkeypatch)
        want = je.fetch_leaf_stage(
            je.run_leaf_stage_async(codes, lengths, out_mode=out_mode),
            lengths, codes=codes, out_mode=out_mode)
    else:
        te._lane_cap_override = 1
        want = je.run_leaf_stage(codes, lengths)
    got = _leaf_stage(te, codes, lengths, out_mode)
    assert te.escalations == (1 if cap == "events" else 4)
    _assert_leaf_equal(want, got)
    _assert_leaf_equal(_leaf_stage(th, codes, lengths), got,
                       ("present", "d", "closest_slot", "hist", "ratio"))


def test_exhausted_tiers_raise(monkeypatch):
    """Probe overflow at every tier: RuntimeError, never a capped result
    returned as exact."""
    _, te, _, codes, lengths = _engines("dense", monkeypatch)
    orig = engine.QueryEngine._event_caps
    monkeypatch.setattr(engine.QueryEngine, "_event_caps",
                        lambda self, B, P, tier: orig(self, B, P, tier)[:2]
                        + (8,))
    with pytest.raises(RuntimeError, match="tiers exhausted"):
        _leaf_stage(te, codes, lengths, "dist")
    assert te.escalations == 4


def test_sort_events_branches_agree():
    """The packed-key sort and the two stable sorts order events alike."""
    rng = np.random.default_rng(3)
    n, N, S, P = 5000, 64, 384, 166
    nb = torch.from_numpy(rng.integers(0, N, n).astype(np.int32))
    leaf = torch.from_numpy(rng.integers(0, S, n).astype(np.int32))
    k3 = torch.from_numpy(rng.integers(0, 8 * P, n).astype(np.int32))
    tv = torch.from_numpy(rng.random(n) < 0.8)
    leaf = torch.where(tv, leaf, 0)       # as event_probe_lanes passes it
    a = event_probe.sort_events(nb, leaf, k3, tv, N, S, packed=True)
    b = event_probe.sort_events(nb, leaf, k3, tv, N, S, packed=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(a[3].any()) and int((a[0] < N).sum()) == int(tv.sum())


# ---------------------------------------------- reference faults avoided

def test_heavy_id_at_or_above_2_23_decodes():
    hids = np.array([0, 5, 2 ** 23 - 1, 2 ** 23, 2 ** 23 + 5, 2 ** 24 - 3])
    word0 = (((hids + 1) << 8) | 7).astype(np.uint32).view(np.int32)
    got = event_probe.heavy_id(torch.from_numpy(word0), 2 ** 24 - 1)
    assert got.tolist() == hids.tolist()
    # the reference's decode (arithmetic shift, no mask) clips them to 0
    ref = np.clip((word0 >> 8) - 1, 0, 2 ** 24 - 2)
    assert (ref[hids >= 2 ** 23] == 0).all()


def test_resident_overflow_recovers_at_tier_1(monkeypatch):
    """A batch of correlated reads (one random read repeated, every 64th
    read a real one) overflows the tier-0 resident-lane compaction: every
    compaction block holds one read position, so half of them hold only
    resident lanes. The port's cap grows with the tier (the reference's
    does not, and exhausts every tier), so tier 1 recovers the hybrid
    engine's result."""
    _, te, th, codes, lengths = _engines("m4", monkeypatch)
    rng = np.random.default_rng(4)
    B = 1024
    batch = np.repeat(rng.integers(0, 4, (1, 150)).astype(np.uint8), B, 0)
    batch[::64] = codes[np.arange(B // 64) % len(codes)]
    blen = np.full(B, 150, np.int32)
    Np = 2 * B * (150 - te.lsh.k + 1)
    assert te._resident_cap(Np, 0) < Np and te._resident_cap(Np, 1) is None
    assert int(te.run_leaf_stage_async(batch, blen).get()[-1]) == 1
    got = _leaf_stage(te, batch, blen, "dist")
    assert te.escalations == 1
    _assert_leaf_equal(_leaf_stage(th, batch, blen, "dist"), got,
                       ("present", "d", "closest_slot", "closest_d"))
    assert got.present.sum() > 16
    # the overflow is the resident compaction's: without it, none
    monkeypatch.setattr(engine.QueryEngine, "_resident_cap",
                        lambda self, Np, tier: None)
    assert int(te.run_leaf_stage_async(batch, blen).get()[-1]) == 0


def test_heavy_cap_above_the_compacted_lanes(monkeypatch):
    """With the reference's unscaled resident cap, tier 2's heavy cap KH
    exceeds the compacted lane count; the reference's reshape to KH * MB
    then fails while tracing. The port sizes the tail by the lanes it
    compacted and gives tier 0's result."""
    _, te, th, codes, lengths = _engines("m4", monkeypatch)
    B, P = codes.shape[0], codes.shape[1] - te.lsh.k + 1
    kr0 = te._resident_cap(2 * B * P, 0)
    monkeypatch.setattr(engine.QueryEngine, "_resident_cap",
                        lambda self, Np, tier: kr0)
    assert te._event_caps(B, P, 2)[1] > kr0
    want = te.run_leaf_stage_async(codes, lengths).get()
    got = te.run_tier(codes, lengths, None, 2).get()
    _assert_tuple_equal(want, got)
    assert int(got[-1]) == 0


def test_empty_leaf_slot_range_raises():
    jdi, _, _ = _world("dense")
    tdi = DeviceIndex.from_reference(jdi)
    se = int(tdi.se_v[0])
    off = tdi.leaf_csr_off.copy()
    off[se + 1] = off[se]                         # color se: no leaf slot
    bad = dataclasses.replace(tdi, se_mask=None, leaf_csr_off=off)
    with pytest.raises(ValueError, match="empty leaf-slot range"):
        engine.QueryEngine(bad, device="cpu")


# ----------------------------------------- 384 leaves: event mode by size

@pytest.fixture(scope="module")
def big_world(tmp_path_factory):
    """tests/test_event_probe.py::big_world, built by each package, saved
    by the port as a native index with 6 reads as FASTQ."""
    nleaves = (MASK_W_CAP * 32) * 3 // 2              # 384 leaves
    rng = np.random.default_rng(90)
    nwk, genomes = worldgen.make_world(rng, nleaves=nleaves, glen=420,
                                       rate=0.03)
    params = IndexParams(lsh=LSHParams.generate(21, 9, 2, seed=9),
                         w=27, r=1, frac=True)
    tree = Tree.parse(nwk)
    names = sorted(genomes)
    sources = {n: (lambda n=n: iter([seq_to_codes(genomes[n][0])]))
               for n in names}
    jdi = JDeviceIndex.from_built(jbuild(names, sources, params, tree,
                                         progress=False))
    built = build_index_from_sources(names, sources, params, tree,
                                     progress=False)
    d = tmp_path_factory.mktemp("torch_event_big")
    save_native(built, str(d / "idx"))
    reads = worldgen.sample_reads(np.random.default_rng(91), genomes, n=6,
                                  rlen=120, mut=0.04)
    with open(d / "q.fq", "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    return jdi, DeviceIndex.from_built(built), reads, d


def test_big_world_index_matches_reference(big_world):
    jdi, tdi, _, _ = big_world
    assert jdi.se_mask is None and tdi.se_mask is None
    assert tdi.nleafslots == 384
    _assert_device_index_equal(jdi, tdi)
    _assert_device_index_equal(jdi, DeviceIndex.from_reference(jdi))


def test_big_world_leaf_stage_matches_reference(big_world):
    jdi, tdi, reads, _ = big_world
    je = jengine.QueryEngine(jdi, 4)
    te = engine.QueryEngine(tdi, 4, device="cpu")
    assert je.mode == te.mode == "event" and te.W == 12
    for place in (False, True):
        assert (te.suggested_batch_reads(place)
                == je.suggested_batch_reads(place))
    from krepp_tpu_torch.core.codec import pad_codes_batch

    codes, lengths = pad_codes_batch([seq_to_codes(s) for _, s in reads])
    lr = _leaf_stage(te, codes, lengths)
    _assert_leaf_equal(je.run_leaf_stage(codes, lengths), lr)
    assert lr.present.sum() > 0


@pytest.mark.parametrize("cmd", ["dist", "place"])
def test_big_world_cli_output_is_byte_identical(big_world, cmd, capsys):
    """Both packages' CLIs on the saved 384-leaf index (the port's in this
    process): the same bytes but for the invocation; place takes the lane
    formulation."""
    _, _, _, d = big_world
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO}/tests",
               JAX_PLATFORMS="cpu")
    want = subprocess.run([sys.executable, "-m", "krepp_tpu", cmd, "-q",
                           "q.fq", "-i", "idx"], cwd=d, env=env,
                          capture_output=True, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    out = str(d / f"{cmd}.out")
    assert cli.main(["--verbose", cmd, "-q", str(d / "q.fq"), "-i",
                     str(d / "idx"), "-o", out, "--device", "cpu"]) == 0
    err = capsys.readouterr().err

    def masked(text):
        return [ln for ln in text.splitlines() if "invocation" not in ln]

    with open(out) as f:
        got = masked(f.read())
    assert got == masked(want.stdout) and len(got) > 3
    assert f'{cmd} stats: {{"mode": "event", "hflavor": "se", "W": 12' in err
    if cmd == "place":
        assert '"formulation": "lanes"' in err
