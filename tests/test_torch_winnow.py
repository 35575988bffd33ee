"""The port's winnowers against krepp_tpu's: the int64 hash pieces
(xur64, the unsigned compare, bp64), `_window_stats`, the device winnower
`winnow_device` (single contigs, the chunked path, the trailing-N fallback,
the zero entry, a tile batch, a window wider than the C winnower's), the
sdust-masked extractor, and the three winnowers of `_extract_genome`
against each other. The same numpy-seeded inputs go through the JAX
function (jitted, on the CPU) and the port with device="cpu".
Tolerance: none; every compared array is integer and must be equal element
for element, rho equal as floats."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krepp_tpu import params as jparams
from krepp_tpu.core import codec as jcodec
from krepp_tpu.core import masked_extract as jmasked
from krepp_tpu.core import minimizer as jminimizer
from krepp_tpu.core import u64
from krepp_tpu.core import winnow_device as jwd
from krepp_tpu.index import build as jbuild
from krepp_tpu_torch import params
from krepp_tpu_torch.core import (codec, masked_extract, minimizer,
                                  winnow_device)
from krepp_tpu_torch.index import build
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)


def both_params(k=27, h=11, w=35, m=4, r=1, frac=True, seed=5, **kw):
    """The same parameters as krepp_tpu's and as the port's classes."""
    return tuple(
        mod.IndexParams(lsh=mod.LSHParams.generate(k, h, m, seed=seed), w=w,
                        r=r, frac=frac, **kw) for mod in (jparams, params))


def rand_codes(rng, n, with_n=False):
    p = [0.23, 0.23, 0.23, 0.23, 0.08] if with_n else [0.25] * 4 + [0.0]
    return rng.choice(5, size=n, p=p).astype(np.uint8)


def padded_codes(codes):
    out = np.full(jminimizer._round_len(len(codes)), 4, np.uint8)
    out[: len(codes)] = codes
    return out


def u64_of(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def keys_of(rows, res):
    return np.asarray(rows).astype(np.uint64) << np.uint64(32) \
        | np.asarray(res).astype(np.uint64)


EDGES = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1,
                  2 ** 32 - 1, 2 ** 32, 2 ** 33, 0xFF51AFD7ED558CCD,
                  0xC4CEB9FE1A85EC53, 0x8000000080000000], np.uint64)


# ----------------------------------------------------- 64-bit hash pieces
def test_xur64_equals_the_u32_pair_form():
    rng = np.random.default_rng(1)
    v = np.concatenate([EDGES, rng.integers(0, 2 ** 64, 20000,
                                            dtype=np.uint64)])
    hi, lo = (v >> np.uint64(32)).astype(np.uint32), v.astype(np.uint32)
    want = u64.to_numpy_u64(*u64.xur64(jnp.asarray(hi), jnp.asarray(lo)))
    got = u64_of(minimizer.xur64(torch.from_numpy(v.view(np.int64))))
    assert np.array_equal(want, got)
    assert len(np.unique(got)) == len(np.unique(v))          # a bijection


def test_unsigned_compare_equals_less64():
    rng = np.random.default_rng(2)
    a = np.concatenate([np.repeat(EDGES, len(EDGES)),
                        rng.integers(0, 2 ** 64, 5000, dtype=np.uint64)])
    b = np.concatenate([np.tile(EDGES, len(EDGES)),
                        rng.integers(0, 2 ** 64, 5000, dtype=np.uint64)])
    want = np.asarray(u64.less64(
        *(jnp.asarray(x) for x in ((a >> np.uint64(32)).astype(np.uint32),
                                   a.astype(np.uint32),
                                   (b >> np.uint64(32)).astype(np.uint32),
                                   b.astype(np.uint32)))))
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))
    assert np.array_equal(want, minimizer.less_u64(ta, tb).numpy())
    assert np.array_equal(want, a < b)
    # the invalid sentinel (u64 max, -1 as int64) loses every compare
    assert not minimizer.less_u64(torch.full_like(ta, -1), ta).any()


@pytest.mark.parametrize("k", [19, 27, 29, 32])
def test_bp64_equals_the_pair(k):
    rng = np.random.default_rng(k)
    codes = np.stack([rand_codes(rng, 300), rand_codes(rng, 300, True)])
    codes[0, :k] = 3                     # the top bits set (the sign, k=32)
    hi, lo = jcodec.bp64_pair(jnp.asarray(codes), k)
    got = codec.bp64(torch.from_numpy(codes), k)
    assert got.dtype == torch.int64 and got.shape == (2, 300 - k + 1)
    assert np.array_equal(u64.to_numpy_u64(hi, lo), u64_of(got))
    assert int(u64_of(got)[0, 0]) == 4 ** k - 1


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("w", [27, 35])
def test_window_stats_match(w, with_n):
    jp, tp = both_params(w=w)
    rng = np.random.default_rng(w + with_n)
    codes = np.stack([rand_codes(rng, 1024, with_n) for _ in range(2)])
    want = [np.asarray(x) for x in
            jminimizer._window_stats(jnp.asarray(codes), jp.lsh, w)]
    valid_k, valid_w, z, rix, res = minimizer._window_stats(
        torch.from_numpy(codes), tp.lsh, w)
    z = u64_of(z)
    got = [valid_k.numpy(), valid_w.numpy(),
           (z >> np.uint64(32)).astype(np.uint32), z.astype(np.uint32),
           rix.numpy().view(np.uint32), res.numpy().view(np.uint32)]
    for name, a, b in zip(("valid_k", "valid_w", "z_hi", "z_lo", "rix",
                           "res"), want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert valid_k.any() and (with_n != bool(valid_k.all()))
    assert not valid_w[:, : w - 27].any()


# -------------------------------------------------------- winnow_device
def winnow_one(codes, n, tp, t_lo=None, do_final=None):
    """One contig through the port's winnow_device (a batch of one tile),
    with the tile axis taken off nuniq and the registers."""
    rows, res, nuniq, c1, c2 = winnow_device.winnow_device(
        torch.from_numpy(codes)[None], [n], tp.lsh, tp.w, tp.r, tp.frac,
        t_lo=None if t_lo is None else [t_lo],
        do_final=None if do_final is None else [do_final])
    return rows, res, nuniq[0], c1[0], c2[0]


def assert_winnow_equal(want, got):
    """(crow, cres, nuniq, c1reg, c2reg) of krepp_tpu's winnow_device (a
    fixed padded shape; empty registers come as int32 min and are cast as
    its `_fetch_result` casts them) against the port's compacted form."""
    crow, cres, nuniq, c1reg, c2reg = (np.asarray(x) for x in want)
    rows, res, nu, c1, c2 = (x.numpy() for x in got)
    assert int(nuniq) == int(nu) == len(rows) == len(res)
    assert np.array_equal(crow[:nu], rows) and np.array_equal(cres[:nu], res)
    assert np.array_equal(c1reg.astype(np.uint8), c1)
    assert np.array_equal(c2reg.astype(np.uint8), c2)
    assert c1.max() <= 21 and c1.min() >= 0
    return int(nu)


@pytest.mark.parametrize("n", [40, 123, 1000, 5000])
@pytest.mark.parametrize("with_n", [False, True])
def test_winnow_device_matches(n, with_n):
    rng = np.random.default_rng(n * 7 + with_n)
    jp, tp = both_params()
    codes = rand_codes(rng, n, with_n)
    want = jwd.winnow_device(jnp.asarray(padded_codes(codes)), jnp.int32(n),
                             jp.lsh, jp.w, jp.r, jp.frac)
    got = winnow_one(padded_codes(codes), n, tp)
    assert_winnow_equal(want, got)
    # the port pads nothing: the bare contig gives the same
    bare = winnow_one(codes, n, tp)
    for a, b in zip(got, bare):
        assert torch.equal(a, b)
    # and through the host wrappers, short contigs skipped by both
    jout = jwd.extract_sequence_mers_device(codes, jp)
    tout = winnow_device.extract_sequence_mers_device(codes, tp, "cpu")
    assert (jout is None) == (tout is None) == (n < 35)
    if jout is not None:
        for a, b in zip(jout, tout):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("m,r,frac", [(4, 0, False), (4, 3, True),
                                      (2, 1, False), (1, 0, True)])
def test_winnow_device_residue_filters_match(m, r, frac):
    rng = np.random.default_rng(m * 10 + r)
    jp, tp = both_params(m=m, r=r, frac=frac)
    codes = padded_codes(rand_codes(rng, 1000))
    want = jwd.winnow_device(jnp.asarray(codes), jnp.int32(1000), jp.lsh,
                             jp.w, jp.r, jp.frac)
    got = winnow_one(codes, 1000, tp)
    assert assert_winnow_equal(want, got) > 20


def test_winnow_device_zero_entry_when_fewer_than_ldiff_kmers():
    """A contig of at least w bases with fewer than ldiff valid k-mers, the
    last window valid: the end-of-sequence emission takes the zero entry
    (row 0, residual 0, hash 0), which enters the c2 registers too."""
    rng = np.random.default_rng(8)
    jp, tp = both_params(m=1, r=0)
    codes = np.concatenate([rand_codes(rng, 20), [4], rand_codes(rng, 30)]
                           ).astype(np.uint8)
    want = jwd.winnow_device(jnp.asarray(padded_codes(codes)),
                             jnp.int32(len(codes)), jp.lsh, jp.w, jp.r,
                             jp.frac)
    got = winnow_one(codes, len(codes), tp)
    assert assert_winnow_equal(want, got) == 1
    assert got[0].tolist() == [0] and got[1].tolist() == [0]
    assert got[4][0] == 21 and int((got[4] > 0).sum()) == 1
    assert int((got[3] > 0).sum()) == 4                   # 4 valid k-mers


def _chunked_both(monkeypatch, codes, jp, tp):
    monkeypatch.setattr(jwd, "_CHUNK", 2048)
    monkeypatch.setattr(winnow_device, "_CHUNK", 2048)
    want = jwd.extract_sequence_mers_device(codes, jp)
    got = winnow_device.extract_sequence_mers_device(codes, tp, "cpu")
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return got


@pytest.mark.parametrize("n,with_n", [(6000, False), (9000, True),
                                      (4100, True), (2049, False)])
def test_winnow_device_chunked_matches(monkeypatch, n, with_n):
    """Tiles of 2048 bases in both packages; more tiles than TILE_GROUP in
    one of the cases, so the port's batches of tiles are cut too."""
    rng = np.random.default_rng(71 + n)
    jp, tp = both_params()
    monkeypatch.setattr(winnow_device, "TILE_GROUP", 2)
    codes = rand_codes(rng, n, with_n)
    rows, res, c1, c2 = _chunked_both(monkeypatch, codes, jp, tp)
    specs = winnow_device.contig_tiles(codes, tp)   # None: the N-starved tail
    assert len(specs) == -(-(n - 26) // 2014) if specs else n == 4100
    # and the host compaction path agrees on the set
    h = minimizer.extract_sequence_mers(codes, tp, "cpu")
    assert np.array_equal(np.unique(keys_of(h[0], h[1])), keys_of(rows, res))


def test_winnow_device_chunked_trailing_n_fallback(monkeypatch):
    """A trailing N-flood starves the last tile's end-of-sequence window:
    both packages take the exact host path."""
    rng = np.random.default_rng(72)
    jp, tp = both_params()
    codes = np.concatenate([rand_codes(rng, 7000), np.full(2500, 4),
                            rand_codes(rng, 30)]).astype(np.uint8)
    monkeypatch.setattr(winnow_device, "_CHUNK", 2048)
    assert winnow_device.contig_tiles(codes, tp) is None
    rows, _, _, _ = _chunked_both(monkeypatch, codes, jp, tp)
    assert len(rows) > 300


def test_winnow_device_tile_batch_equals_single_calls():
    """[T, L] tiles with their own n_real, t_lo and do_final against T
    calls of one tile each, and against krepp_tpu's per tile."""
    rng = np.random.default_rng(9)
    jp, tp = both_params()
    L = 1024
    tiles = [(1024, 0, True, False), (700, 8, False, True),
             (1000, 8, True, True), (30, 0, True, False),
             (1024, 500, False, False)]      # (n_real, t_lo, final, with_n)
    codes = np.full((len(tiles), L), 4, np.uint8)
    for i, (n, _, _, with_n) in enumerate(tiles):
        codes[i, :n] = rand_codes(rng, n, with_n)
    n_real = [t[0] for t in tiles]
    t_lo = [t[1] for t in tiles]
    fin = [t[2] for t in tiles]
    rows, res, nuniq, c1, c2 = winnow_device.winnow_device(
        torch.from_numpy(codes), torch.tensor(n_real), tp.lsh, tp.w, tp.r,
        tp.frac, t_lo=torch.tensor(t_lo), do_final=torch.tensor(fin))
    assert nuniq.shape == (5,) and c1.shape == c2.shape == (5, 4096)
    assert int(nuniq.sum()) == len(rows) == len(res) and nuniq[0] > 50
    ends = np.cumsum(nuniq.numpy())
    for i in range(len(tiles)):
        piece = (rows[ends[i] - nuniq[i]: ends[i]],
                 res[ends[i] - nuniq[i]: ends[i]], nuniq[i], c1[i], c2[i])
        one = winnow_one(codes[i], n_real[i], tp, t_lo[i], fin[i])
        for a, b in zip(piece, one):
            assert torch.equal(a, b), i
        want = jwd.winnow_device(
            jnp.asarray(codes[i]), jnp.int32(n_real[i]), jp.lsh, jp.w, jp.r,
            jp.frac, t_lo=jnp.int32(t_lo[i]), do_final=jnp.bool_(fin[i]))
        assert_winnow_equal(want, piece)


def test_winnow_device_window_wider_than_the_c_winnowers():
    """ldiff = 4101 > 4096, where the device winnower is the only one.
    krepp_tpu's device program unrolls ldiff - 1 passes and does not compile
    in a test's time on the CPU, so the reference here is its host path
    (minimizer.extract_sequence_mers), which its own tests hold equal to
    its device path."""
    from krepp_tpu.core.hll import HyperLogLog
    from krepp_tpu_torch.core import native_extract

    rng = np.random.default_rng(10)
    jp, tp = both_params(w=27 + 4100, m=1, r=0)
    assert not native_extract.window_fits(tp)
    codes = rand_codes(rng, 150_000)   # 13 doubling passes, ~70 minimizers
    codes[5000:5003] = 4
    rows, res, c1, c2 = winnow_device.extract_sequence_mers_device(
        codes, tp, "cpu")
    h_rows, h_res, h_c1, h_c2 = jminimizer.extract_sequence_mers(codes, jp)
    assert np.array_equal(np.unique(keys_of(h_rows, h_res)),
                          keys_of(rows, res)) and len(rows) > 50
    for hashes, reg in ((h_c1, c1), (h_c2, c2)):
        hll = HyperLogLog(12)
        hll.add_many(hashes)
        assert np.array_equal(hll.M, reg)
    assert winnow_device.extract_sequence_mers_device(
        codes[:4000], tp, "cpu") is None                      # shorter than w


def test_trailing_argmin_equals_the_pass_per_offset_loop():
    """The doubling sliding minimum against the original's formulation
    (ldiff - 1 shifted compare-and-select passes), sentinels included."""
    rng = np.random.default_rng(11)
    key = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, (3, 400)))
    key[rng.random((3, 400)) < 0.1] = 2 ** 63 - 1
    for width in (1, 2, 3, 7, 8, 9, 100, 400, 1000):
        best, off = winnow_device._trailing_argmin(key, width)
        want = key.clone()
        for s in range(1, min(width, 400)):
            want[:, s:] = torch.minimum(want[:, s:], key[:, :-s])
        assert torch.equal(best, want), width
        t = torch.arange(400)[None]
        assert torch.equal(key.gather(1, t - off), best), width
        assert int(off.max()) < width and int((t - off).min()) >= 0


def test_hll_ranks_equal_the_host_estimators():
    from krepp_tpu_torch.core.hll import HyperLogLog

    rng = np.random.default_rng(12)
    h = np.concatenate([rng.integers(0, 2 ** 32, 5000, dtype=np.uint64),
                        [0, 1, 0xFFFFF, 0x100000, 0xFFFFFFFF, 0xFFF00000,
                         0x00080000, 0x00000800]]).astype(np.uint32)
    idx, rank = winnow_device._hll_ranks(torch.from_numpy(h.astype(np.int64)))
    for i in range(len(h)):
        one = HyperLogLog(12)
        one.add_many(h[i: i + 1])
        assert one.M[int(idx[i])] == int(rank[i]), hex(h[i])
    mask = torch.from_numpy(rng.random(len(h)) < 0.5)
    want = HyperLogLog(12)
    want.add_many(h[mask.numpy()])
    got = winnow_device._hll_registers(
        torch.from_numpy(h.astype(np.int64))[None], mask[None])
    assert np.array_equal(want.M, got[0].numpy())


# --------------------------------------------------------- sdust masking
def _masked_both(codes, jp, tp):
    want = jmasked.extract_sequence_mers_masked(codes, jp)
    got = masked_extract.extract_sequence_mers_masked(codes, tp, "cpu")
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return got


def test_masked_extract_no_regions_matches():
    rng = np.random.default_rng(5)
    jp, tp = both_params()
    codes = rng.choice(5, size=2000, p=[0.24, 0.24, 0.24, 0.24, 0.04]
                       ).astype(np.uint8)
    rows, res, c1, c2 = _masked_both(codes, jp, tp)
    plain = minimizer.extract_sequence_mers(codes, tp, "cpu")
    assert np.array_equal(plain[0], rows) and np.array_equal(plain[1], res)
    assert np.array_equal(np.sort(plain[2]), np.sort(c1))
    assert np.array_equal(np.sort(plain[3]), np.sort(c2))


def test_masked_extract_skips_masked_kmers_as_the_reference():
    rng = np.random.default_rng(6)
    jp, tp = both_params(m=2, sdust_t=20, sdust_w=64)
    body = rand_codes(rng, 600)
    codes = np.concatenate([body[:300], np.zeros(120, np.uint8), body[300:]])
    rows_m, _, c1m, _ = _masked_both(codes, jp, tp)
    rows_p, _, c1p, _ = _masked_both(
        codes, dataclasses.replace(jp, sdust_t=0, sdust_w=0),
        dataclasses.replace(tp, sdust_t=0, sdust_w=0))
    assert len(rows_m) < len(rows_p)
    assert len(c1p) - len(c1m) == tp.k - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_extract_planted_low_complexity_matches(seed):
    """Random contigs with planted homopolymers, tandem repeats and N."""
    rng = np.random.default_rng(100 + seed)
    jp, tp = both_params(sdust_t=20, sdust_w=64)
    codes = rand_codes(rng, 2048)
    for _ in range(4):
        at = int(rng.integers(0, 1900))
        unit = rand_codes(rng, int(rng.integers(1, 5)))
        run = int(rng.integers(40, 140))
        codes[at: at + run] = np.resize(unit, run)[: len(codes) - at]
    codes[int(rng.integers(0, 2048))] = 4
    rows, res, c1, c2 = _masked_both(codes, jp, tp)
    from krepp_tpu_torch.core.sdust import sdust
    assert len(sdust(codes, 20, 64)) >= 1 and len(rows) > 10
    want = jmasked.extract_genome_mers_masked([codes, codes[:20]], jp)
    got = masked_extract.extract_genome_mers_masked([codes, codes[:20]], tp,
                                                    "cpu")
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    assert want[2] == got[2] and got[2] > 0


# ------------------------------------------- the three winnowers, one genome
def test_the_three_winnowers_agree_with_each_other_and_the_reference(
        monkeypatch):
    rng = np.random.default_rng(4)
    jp, tp = both_params()
    contigs = [rand_codes(rng, 3000), rand_codes(rng, 3000, True),
               rand_codes(rng, 20), rand_codes(rng, 3000)]
    monkeypatch.delenv("KREPP_DEVICE_WINNOW", raising=False)
    outs = {"native": build._extract_genome(contigs, tp, "cpu"),
            "jnative": jbuild._extract_genome(contigs, jp),
            "host": minimizer.extract_genome_mers(contigs, tp, "cpu"),
            "jhost": jminimizer.extract_genome_mers(contigs, jp)}
    monkeypatch.setenv("KREPP_DEVICE_WINNOW", "1")
    outs["device"] = build._extract_genome(contigs, tp, "cpu")
    outs["jdevice"] = jbuild._extract_genome(contigs, jp)
    direct = winnow_device.extract_genome_mers_device(contigs, tp, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(outs["device"][:2],
                                                    direct[:2]))
    want = jbuild._dedupe_genome(*outs["jhost"][:2])
    assert len(want[0]) > 400
    for name, (rows, res, rho) in outs.items():
        got = build._dedupe_genome(rows, res)
        assert np.array_equal(want[0], got[0]), name
        assert np.array_equal(want[1], got[1]), name
        assert rho == outs["jhost"][2], name


def test_extract_genome_routes_as_the_reference(monkeypatch):
    """sdust set -> the masked path, whatever else; KREPP_DEVICE_WINNOW or a
    window the C winnower cannot hold -> the device winnower; else C."""
    from krepp_tpu_torch.core import native_extract

    called = []
    monkeypatch.setattr(masked_extract, "extract_genome_mers_masked",
                        lambda c, p, d: called.append(("masked", d)))
    monkeypatch.setattr(winnow_device, "extract_genome_mers_device",
                        lambda c, p, d: called.append(("device", d)))
    monkeypatch.setattr(native_extract, "extract_genome_mers_native",
                        lambda c, p: called.append(("native", None)))
    _, tp = both_params()
    _, wide = both_params(w=27 + 4096)
    _, masked = both_params(sdust_t=20, sdust_w=64)
    monkeypatch.delenv("KREPP_DEVICE_WINNOW", raising=False)
    build._extract_genome([], tp, "cpu")
    build._extract_genome([], wide, "cpu")
    build._extract_genome([], masked, "cpu")
    monkeypatch.setenv("KREPP_DEVICE_WINNOW", "1")
    build._extract_genome([], tp, "cuda")
    build._extract_genome([], masked, "cpu")
    assert called == [("native", None), ("device", "cpu"), ("masked", "cpu"),
                      ("device", "cuda"), ("masked", "cpu")]


def test_device_paths_raise_without_a_card_and_the_c_path_needs_none(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(13)
    _, tp = both_params()
    _, masked = both_params(sdust_t=20, sdust_w=64)
    contigs = [rand_codes(rng, 500)]
    monkeypatch.delenv("KREPP_DEVICE_WINNOW", raising=False)
    assert len(build._extract_genome(contigs, tp)[0]) > 10   # default cuda
    with pytest.raises(RuntimeError, match="is_available"):
        build._extract_genome(contigs, masked)
    monkeypatch.setenv("KREPP_DEVICE_WINNOW", "1")
    with pytest.raises(RuntimeError, match="is_available"):
        build._extract_genome(contigs, tp)
