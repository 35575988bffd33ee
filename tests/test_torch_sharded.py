"""Port ShardedQueryEngine vs the port's single-device engine and
krepp_tpu's ShardedQueryEngine (on the conftest's 8 virtual CPU devices):
dense (h = 11) and sparse (h = 13) row spaces and buckets up to 9 deep at
meshes 1x2, 2x2, 1x8, 2x4 and 8x1, in hybrid, CSR and event-lane modes,
the engine that runs its cells at once (the default) and the one that
runs them in turn (concurrent=False); dist and place reports of both byte
for byte the one-device port's and krepp_tpu's; a barrier every cell must
reach at once (which the in-turn engine breaks), a failing cell named in
its exception, a tier re-run forced through the heavy cap, a natural
many-genome (no bitmask) world, the per-tier resident cap the port keeps
where the reference's sharded lanes do not, and `--mesh` through the CLI
on the host. Integers equal, `d` within 5e-9."""

import io
import threading

import numpy as np
import pytest
import torch

import jax

from krepp_tpu import testing as jtesting
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu.parallel import mesh as jmesh
from krepp_tpu.query.dist import run_dist as jrun_dist
from krepp_tpu.query.place import PlaceConfig as JPlaceConfig
from krepp_tpu.query.place import run_place as jrun_place
from krepp_tpu_torch import cli
from krepp_tpu_torch import testing as ttesting
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.parallel import boot
from krepp_tpu_torch.parallel.mesh import (ShardedQueryEngine,
                                           make_query_mesh, parse_mesh)
from krepp_tpu_torch.query import engine
from krepp_tpu_torch.query.dist import run_dist
from krepp_tpu_torch.query.place import PlaceConfig, run_place

from test_torch_event import _assert_leaf_equal
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 2), (1, 8), (2, 4), (8, 1)]
MODES = ["hybrid", "csr", "event"]
WORLDS = {
    # tests/test_sharded.py's two row spaces
    "h11-dense": dict(seed=31, nleaves=6, glen=1500, k=27, h=11, m=4),
    "h13-sparse": dict(seed=31, nleaves=6, glen=1500, k=29, h=13, m=4),
    # buckets up to 9 deep: the CSR tail and the E-slot loop run
    "deep": dict(seed=9, nleaves=8, glen=12000, k=23, h=7, w=29, m=2,
                 rate=0.02),
}
FIELDS = ("present", "hist", "closest_slot", "onmers", "d", "match",
          "closest_d", "hist_closest", "uc_closest", "v_closest")
_CACHE = {}


def _world(name):
    if name not in _CACHE:
        built, genomes, _ = jtesting.build_world_index(**WORLDS[name])
        rng = np.random.default_rng(32)
        # 11 reads: a batch that no mesh of 2 or 8 data rows divides
        codes = jtesting.sample_read_codes(rng, genomes, 11, rlen=150,
                                           mut=0.05)
        codes[0, 40:44] = 4
        lengths = np.full(11, 150, np.int32)
        lengths[2] = 101
        _CACHE[name] = (JDeviceIndex.from_built(built), codes, lengths)
    return _CACHE[name]


def _leaf_stage(eng, codes, lengths, out_mode="full"):
    return eng.fetch_leaf_stage(
        eng.run_leaf_stage_async(codes, lengths, out_mode=out_mode), lengths,
        codes=codes, out_mode=out_mode)


def _engines(name, mesh, mode, monkeypatch):
    """(port single-device engine, port sharded engine) in `mode`."""
    jdi, codes, lengths = _world(name)
    if mode == "csr":
        monkeypatch.setattr(engine, "DIRECT_MEM_CAP", 0)
    if mode == "event":
        monkeypatch.setattr(engine, "FORCE_EVENT", True)
    di = DeviceIndex.from_reference(jdi)
    single = engine.QueryEngine(di, 4, device="cpu")
    sharded = ShardedQueryEngine(di, make_query_mesh(*mesh, device="cpu"), 4)
    assert single.mode == sharded.mode == mode
    return single, sharded, codes, lengths


def _in_turn(sharded):
    """The engine of `sharded`'s index and mesh that runs its cells in
    turn (build it while the mode's patches are in place)."""
    return ShardedQueryEngine(sharded.di, sharded.mesh, 4, concurrent=False)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["h11-dense", "h13-sparse", "deep"])
def test_sharded_equals_single_device(name, mode, mesh, monkeypatch):
    single, sharded, codes, lengths = _engines(name, mesh, mode, monkeypatch)
    assert sharded.concurrent and (
        sharded._rowmap(torch.device("cpu")) is not None
        and sharded._dense_space == (name != "h13-sparse"))
    in_turn = _in_turn(sharded)
    want = _leaf_stage(single, codes, lengths)
    for eng in (sharded, in_turn):
        got = _leaf_stage(eng, codes, lengths)
        _assert_leaf_equal(want, got, FIELDS)
        assert got.present.sum() > 10 and got.closest_slot.shape == (11,)
        # the compact dist fetch too
        _assert_leaf_equal(_leaf_stage(single, codes, lengths, "dist_ratio"),
                           _leaf_stage(eng, codes, lengths, "dist_ratio"),
                           ("present", "d", "closest_slot", "hist_closest"))


@pytest.fixture(scope="module")
def report_world(tmp_path_factory):
    """h13-sparse's reads as FASTQ and krepp_tpu's one-device dist and
    place reports of them (its default mode: every mode's report is the
    same)."""
    jdi, codes, _ = _world("h13-sparse")
    fq = str(tmp_path_factory.mktemp("torch_sharded_reports") / "q.fq")
    ttesting.write_fastq(fq, codes)
    want = {}
    for cmd, run, cfg in (("dist", jrun_dist, None),
                          ("place", jrun_place, JPlaceConfig(tabular=True))):
        out = io.StringIO()
        run(jdi, fq, out, "inv", cfg)
        want[cmd] = out.getvalue()
    return fq, want


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_sharded_reports_are_the_reference_reports(report_world, mode, mesh,
                                                   monkeypatch):
    """dist and place --tabular through run_dist / run_place: the engine
    that runs its cells at once, the one that runs them in turn and the
    one-device port, each krepp_tpu's report byte for byte."""
    fq, want = report_world
    single, sharded, _, _ = _engines("h13-sparse", mesh, mode, monkeypatch)
    engines = (single, sharded, _in_turn(sharded))
    for cmd, run, cfg in (("dist", run_dist, None),
                          ("place", run_place, PlaceConfig(tabular=True))):
        for eng in engines:
            out = io.StringIO()
            run(eng.di, fq, out, "inv", cfg, engine_factory=lambda d, t: eng,
                device="cpu")
            assert out.getvalue() == want[cmd], (cmd, type(eng).__name__,
                                                 getattr(eng, "concurrent",
                                                         None))
        assert want[cmd].count("\n") > 11


def _wrap_step(monkeypatch, mode, before):
    """Patch the cell step of `mode` (`_shard_lanes` in the event-lane
    form, else `_shard_probe`) to call before(engine, cell table, the data
    row's codes) first."""
    name = "_shard_lanes" if mode == "event" else "_shard_probe"
    step = getattr(ShardedQueryEngine, name)

    def wrapped(self, t, *args):
        before(self, t, args[0])
        return step(self, t, *args)

    monkeypatch.setattr(ShardedQueryEngine, name, wrapped)


def _within(seconds: float, fn):
    """fn() on a thread of its own; fails unless it ends within `seconds`.
    Returns ("value", result) or ("error", the exception raised)."""
    out = []

    def call():
        try:
            out.append(("value", fn()))
        except BaseException as exc:        # noqa: BLE001 (handed back)
            out.append(("error", exc))

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"still running after {seconds} s"
    return out[0]


@pytest.mark.parametrize("mode", ["hybrid", "event"])
def test_every_cell_runs_at_once(mode, monkeypatch):
    """Each cell's step waits on a barrier of all four cells of a 2x2
    mesh: the default engine passes it (and gives the one-device result),
    the in-turn engine's first cell waits alone and breaks it."""
    single, sharded, codes, lengths = _engines("h11-dense", (2, 2), mode,
                                               monkeypatch)
    in_turn = _in_turn(sharded)
    want = _leaf_stage(single, codes, lengths)
    barrier = []
    _wrap_step(monkeypatch, mode, lambda *_: barrier[-1].wait())
    barrier.append(threading.Barrier(4, timeout=30))
    kind, got = _within(60, lambda: _leaf_stage(sharded, codes, lengths))
    assert kind == "value", got
    _assert_leaf_equal(want, got, FIELDS)
    barrier.append(threading.Barrier(4, timeout=1))
    kind, err = _within(30, lambda: _leaf_stage(in_turn, codes, lengths))
    assert kind == "error" and isinstance(err, threading.BrokenBarrierError)
    assert "in mesh cell (data row 0, shard 0) on cpu" in err.__notes__


@pytest.mark.parametrize("concurrent", [True, False],
                         ids=["at-once", "in-turn"])
@pytest.mark.parametrize("mode", ["hybrid", "event"])
def test_a_failing_cell_is_named_and_nothing_is_merged(mode, concurrent,
                                                       monkeypatch):
    """Cell (1, 0) of a 2x2 mesh raises: the caller gets its exception,
    naming the cell, once the other cells have ended, and no partial was
    merged; the engine then runs the next batch as before."""
    single, sharded, codes, lengths = _engines("h11-dense", (2, 2), mode,
                                               monkeypatch)
    if not concurrent:
        sharded = _in_turn(sharded)
    armed = [True]

    def fail(eng, t, codes):
        # the host repeated: the data rows share each shard's table, and
        # row 1's codes are a view past row 0's
        if armed[0] and t is eng._cells[1, 0] and codes.storage_offset():
            raise ValueError("cell failure")

    merges = []
    reduce = ShardedQueryEngine._reduce
    _wrap_step(monkeypatch, mode, fail)
    monkeypatch.setattr(ShardedQueryEngine, "_reduce", lambda self, *a: (
        merges.append(a[0]), reduce(self, *a))[1])
    kind, err = _within(60, lambda: _leaf_stage(sharded, codes, lengths))
    assert kind == "error" and str(err) == "cell failure", err
    assert err.__notes__ == ["in mesh cell (data row 1, shard 0) on cpu"]
    assert merges == []
    armed[0] = False
    _assert_leaf_equal(_leaf_stage(single, codes, lengths),
                       _leaf_stage(sharded, codes, lengths), FIELDS)
    assert merges


@pytest.mark.parametrize("name,mesh", [("h11-dense", (2, 4)),
                                       ("h13-sparse", (1, 8))])
def test_sharded_equals_the_reference_sharded_engine(name, mesh,
                                                     monkeypatch):
    """The port's sharded engine against krepp_tpu's ShardedQueryEngine on
    the conftest's 8 virtual CPU devices, in hybrid and event-lane mode."""
    assert len(jax.devices()) >= 8
    jdi, codes, lengths = _world(name)
    for event in (False, True):
        if event:
            monkeypatch.setenv("KREPP_EVENT_PROBE", "1")
            monkeypatch.setattr(engine, "FORCE_EVENT", True)
        je = jmesh.ShardedQueryEngine(jdi, jmesh.make_query_mesh(*mesh), 4)
        te = ShardedQueryEngine(DeviceIndex.from_reference(jdi),
                                make_query_mesh(*mesh, device="cpu"), 4)
        assert je.mode == te.mode == ("event" if event else "hybrid")
        want = je.run_leaf_stage(codes, lengths)
        got = _leaf_stage(te, codes, lengths)
        _assert_leaf_equal(want, got, FIELDS)


def test_deep_buckets_and_a_forced_tier_rerun(monkeypatch):
    """9-deep buckets through every mode's tail; a heavy cap of one lane
    overflows tier 0 and the batch re-runs to the single-device result."""
    jdi, codes, lengths = _world("deep")
    di = DeviceIndex.from_reference(jdi)
    want = _leaf_stage(engine.QueryEngine(di, 4, device="cpu"), codes,
                       lengths)
    for mode in ("hybrid", "event"):
        single, sharded, _, _ = _engines("deep", (2, 4), mode, monkeypatch)
        _assert_leaf_equal(want, _leaf_stage(sharded, codes, lengths),
                           FIELDS)
        assert sharded.escalations == 0
    monkeypatch.undo()
    _, sharded, _, _ = _engines("deep", (2, 4), "hybrid", monkeypatch)
    sharded._heavy_cap_override = 1
    _assert_leaf_equal(want, _leaf_stage(sharded, codes, lengths), FIELDS)
    assert sharded.escalations >= 1


def test_many_genome_world_in_event_lanes():
    """A world without bitmasks (300 genomes > 8 mask words), as
    tests/test_sharded.py's: the event lanes across shards equal the
    single-device event lanes."""
    built, genomes, _ = jtesting.build_world_index(
        seed=47, nleaves=300, glen=400, rate=0.08, k=29, h=13, m=4)
    di = DeviceIndex.from_reference(JDeviceIndex.from_built(built))
    assert di.se_mask is None
    codes = jtesting.sample_read_codes(np.random.default_rng(48), genomes,
                                       13, rlen=120, mut=0.04)
    lengths = np.full(13, 120, np.int32)
    want = _leaf_stage(engine.QueryEngine(di, 4, device="cpu"), codes,
                       lengths)
    assert want.present.sum() > 10
    eng = ShardedQueryEngine(di, make_query_mesh(2, 4, device="cpu"), 4)
    assert eng.mode == "event"
    _assert_leaf_equal(want, _leaf_stage(eng, codes, lengths), FIELDS)


def test_shard_resident_cap_grows_by_tier(monkeypatch):
    """The reference's sharded lanes keep one resident cap at every tier
    (mesh.py:349-350), so a batch that overflows it overflows every re-run;
    the port's grows 4x a tier. A tier-0 cap forced to 1,024 lanes
    overflows and the re-run recovers the single-device result."""
    single, sharded, codes, lengths = _engines("h11-dense", (1, 8), "event",
                                               monkeypatch)
    N = 1 << 24
    c0, c1 = (sharded._shard_resident_cap(N, t) for t in (0, 1))
    assert c0 < c1 == min(N, 4 * c0) and sharded._shard_resident_cap(
        N, 3) == N
    monkeypatch.setattr(sharded, "_shard_resident_cap",
                        lambda n, tier: min(n, 16 << (2 * tier)))
    _assert_leaf_equal(_leaf_stage(single, codes, lengths),
                       _leaf_stage(sharded, codes, lengths), FIELDS)
    assert sharded.escalations >= 2


def test_event_tables_over_the_cap_shard_or_name_the_remedy(monkeypatch):
    """An event-mode bucket-row table over DIRECT_MEM_CAP: one device
    raises naming `--mesh 1xN`, one shard raises asking for more shards
    (the reference's assertion, mesh.py:77, never fires: its forced 'se'
    flavor builds a table of any size), and eight shards, each under the
    cap, give the single-device result."""
    single, _, codes, lengths = _engines("h11-dense", (1, 1), "event",
                                         monkeypatch)
    want = _leaf_stage(single, codes, lengths)
    di = single.di
    full = di.nrows_u * (1 + 2 * single.C0) * 4
    monkeypatch.setattr(engine, "DIRECT_MEM_CAP", full // 2)
    with pytest.raises(RuntimeError, match="with --mesh 1xN"):
        engine.QueryEngine(di, 4, device="cpu")
    with pytest.raises(RuntimeError, match="use more shards than 1"):
        ShardedQueryEngine(di, make_query_mesh(1, 1, device="cpu"), 4)
    sharded = ShardedQueryEngine(di, make_query_mesh(1, 8, device="cpu"), 4)
    assert sharded.mode == "event"
    _assert_leaf_equal(want, _leaf_stage(sharded, codes, lengths), FIELDS)


def test_mesh_specs_and_counts_are_checked(monkeypatch, tmp_path):
    """Bad --mesh specs exit with a message; --mesh on the card with too
    few cards names the count; two NCCL ranks on one card raise before
    any process group, never hanging; nothing falls back."""
    for spec in ("2x", "0x1", "2x4x1", "ax2"):
        with pytest.raises(SystemExit, match="DATAxSHARD"):
            parse_mesh(spec)
        with pytest.raises(SystemExit, match="DATAxSHARD"):
            cli.main(["dist", "-q", "q.fq", "-i", "unused", "--mesh", spec,
                      "--device", "cpu"])
    assert parse_mesh("2x4") == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--mesh 1x2 asks for 2 CUDA "
                                           "devices but this machine has 1"):
        make_query_mesh(1, 2, device="cuda")
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 CUDA devices "
                                           "but this machine has 1"):
        boot.init_distributed("localhost:1", 2, 1, backend="nccl")
    assert boot.rank_devices(1, 2, 1) == [0]
    assert boot.rank_devices(1, 2, 4) == [2, 3]
    assert make_query_mesh(2, 2, device="cpu").own()[-1][:2] == (1, 1)


def test_cli_mesh_runs_on_the_host(tmp_path, capsys):
    """`dist` / `place --mesh 1x2 --device cpu` print the single-device
    output; `--mesh 1x2` on a card this machine lacks raises."""
    from krepp_tpu_torch.index.artifact import save_native

    built, genomes, _ = ttesting.build_world_index(**WORLDS["h13-sparse"])
    save_native(built, str(tmp_path / "idx"))
    ttesting.write_fastq(str(tmp_path / "q.fq"), _world("h13-sparse")[1])
    base = ["-q", str(tmp_path / "q.fq"), "-i", str(tmp_path / "idx"),
            "--device", "cpu"]
    for cmd in (["dist"], ["place", "--tabular"], ["place"]):
        out = {}
        for mesh in ([], ["--mesh", "1x2"], ["--mesh", "2x1"]):
            assert cli.main(cmd + base + mesh) == 0
            out[len(out)] = capsys.readouterr().out.splitlines()[1:]
        assert out[0] == out[1] == out[2] and len(out[0]) > 11
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(["dist"] + base[:-2] + ["--mesh", "1x2"])


def test_chip_smoke_overlap_counts_two_or_more_busy_cards():
    """chip_smoke.py's overlap reading of a profiled pass: each card's
    entries summed and merged, and the time in which two or more cards
    were busy at once."""
    import chip_smoke

    ms = 1_000_000
    summed, busy, both = chip_smoke.overlap_ms({
        0: [(0, 4 * ms), (2 * ms, 5 * ms), (9 * ms, 10 * ms)],
        1: [(4 * ms, 7 * ms)],               # with card 0 in [4, 5)
        2: [(5 * ms, 6 * ms), (6 * ms, 9 * ms)],   # [5, 7) with card 1
    })
    assert summed == {0: 8.0, 1: 3.0, 2: 4.0}
    assert busy == {0: 6.0, 1: 3.0, 2: 4.0}
    assert both == 3.0
    assert chip_smoke.overlap_ms({0: [(0, ms)], 1: [(ms, 2 * ms)]})[2] == 0


def test_host_wait_gives_the_turn_up_while_the_card_drains(monkeypatch):
    """core/host_turn.py: a cell thread that waits for its card (host_int,
    host_wait) lets go of its engine's turn for the wait and holds it
    again after; off a turn, and for host tensors, it only waits."""
    from krepp_tpu_torch.core.host_turn import host_int, host_turn, host_wait

    turn = threading.Lock()
    free = []

    class Stream:
        def synchronize(self):
            free.append(turn.acquire(blocking=False))
            turn.release()

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    card = torch.device("cuda", 0)
    with host_turn(turn):
        host_wait(card)
        assert turn.locked() and free == [True]
        assert host_int(torch.tensor([7])) == 7 and free == [True]
    # off a turn it waits for the card too, holding no turn
    host_wait(card)
    assert free == [True, True] and not turn.locked()
