"""probe_hist_tiles and hdist_chunk: the port's plain versions vs the
Pallas kernels (interpret mode on the CPU), and the CUDA kernels vs the
plain versions on a card. Integer outputs must be equal.

JAX is imported inside the parity tests only, so that the card's machine
(which has no JAX) can run the cuda-marked tests:
    python -m pytest --noconftest -m cuda tests/test_torch_tiles.py
"""

import numpy as np
import pytest
import torch

from krepp_tpu_torch.query import kernels
from krepp_tpu_torch.testing import tiles_inputs

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _torch_args(res, light, d, mask_tab):
    return (_t(res), _t(light), _t(d),
            None if mask_tab is None else _t(mask_tab))


def _pallas_planes(d, mask_tab, C0, W):
    """Gathered rows -> the Pallas kernel's enc [N, C0, P] and mask
    [N, W*C0, P] planes (word-major), as the JAX engine lays them out."""
    if mask_tab is None:
        enc = np.stack([d[..., 1 + c * (1 + W)] for c in range(C0)], -1)
        msk = np.stack([d[..., 2 + c * (1 + W): 2 + c * (1 + W) + W]
                        for c in range(C0)], -2)            # [N, P, C0, W]
    else:
        enc = d[..., 1: 1 + C0]
        se = np.clip(d[..., 1 + C0: 1 + 2 * C0].astype(np.int64), 0,
                     len(mask_tab) - 1)
        msk = mask_tab[se]
    msk_g = np.concatenate([msk[..., w].transpose(0, 2, 1)
                            for w in range(W)], axis=1)
    return np.ascontiguousarray(enc.transpose(0, 2, 1)), msk_g


TILES_CASES = [  # (N, P, C0, W, S, th, flavor, dark)
    (70, 166, 2, 1, 32, 4, "embed", False),
    (65, 166, 2, 2, 48, 4, "embed", False),
    (33, 300, 2, 2, 33, 6, "embed", False),
    (67, 1, 2, 3, 70, 4, "se", False),
    (41, 166, 2, 3, 70, 6, "se", False),
    (37, 166, 2, 8, 256, 4, "se", False),
    (19, 300, 1, 8, 256, 6, "se", False),
    (23, 166, 1, 1, 32, 6, "embed", False),
    (29, 166, 2, 8, 256, 4, "se", True),
]


# shapes the CUDA kernel's staging makes delicate: row spans of
# P * width * 4 bytes that are not multiples of 16, one row, fewer rows than
# a block takes, every leaf set, leaf S - 1 alone, S = 33 and S = 255
TILES_STAGING_CASES = [  # (N, P, C0, W, S, th, flavor, dark, leafsets)
    (21, 1, 2, 8, 255, 4, "se", False, "random"),
    (19, 122, 2, 8, 256, 4, "se", False, "random"),
    (17, 166, 2, 8, 256, 4, "se", False, "dense"),
    (11, 255, 2, 8, 255, 4, "embed", False, "dense"),
    (1, 164, 2, 8, 256, 4, "se", False, "random"),
    (13, 164, 2, 8, 256, 4, "se", False, "last"),
    (15, 122, 2, 2, 33, 4, "embed", False, "last"),
    (9, 166, 1, 2, 33, 4, "se", False, "random"),
]


@pytest.mark.parametrize("N,P,C0,W,S,th,flavor,dark", TILES_CASES)
def test_tiles_ref_matches_pallas_interpret(N, P, C0, W, S, th, flavor,
                                             dark):
    _check_ref_vs_pallas(N, P, C0, W, S, th, flavor, dark, "random")


@pytest.mark.parametrize("N,P,C0,W,S,th,flavor,dark,leafsets",
                         TILES_STAGING_CASES)
def test_tiles_ref_matches_pallas_on_staging_shapes(N, P, C0, W, S, th,
                                                     flavor, dark, leafsets):
    _check_ref_vs_pallas(N, P, C0, W, S, th, flavor, dark, leafsets)


def _check_ref_vs_pallas(N, P, C0, W, S, th, flavor, dark, leafsets):
    import jax.numpy as jnp

    from krepp_tpu.query.pallas_kernels import probe_hist_tiles as jtiles

    rng = np.random.default_rng(N * 7 + P + W + S + th)
    res, light, d, mask_tab = tiles_inputs(rng, N, P, C0, W, S, th, flavor,
                                           dark, 97, leafsets)
    enc_g, msk_g = _pallas_planes(d, mask_tab, C0, W)
    want_h, want_m = jtiles(jnp.asarray(enc_g), jnp.asarray(msk_g),
                            jnp.asarray(res), jnp.asarray(light), th, C0, W,
                            S, interpret=True)
    got_h, got_m = kernels.probe_hist_tiles_ref(
        *_torch_args(res, light, d, mask_tab), th, C0, W, S)
    assert np.array_equal(np.asarray(want_h), got_h.numpy())
    assert np.array_equal(np.asarray(want_m), got_m.numpy())
    if dark:
        assert int(got_h.sum()) == 0 and bool((got_m == 255).all())
    else:
        assert got_h.sum() > 0 and (got_m.numpy() < 255).any()
    if leafsets == "last":
        assert int(got_h[:, :S - 1].sum()) == 0


def _transpose32(v):
    """The kernels' butterfly on one warp's 32 words (numpy u64 holding
    u32): lane s ends with bit p = what bit s of lane p was. Five stages;
    a lane keeps half its columns and takes its partner's, rotated."""
    lane = np.arange(32)
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        keep = np.where(lane & j, ~m & 0xFFFFFFFF, m).astype(np.uint64)
        rot = np.where(lane & j, 32 - j, j).astype(np.uint64)
        t = v[lane ^ j]
        r = ((t << rot) | (t >> (np.uint64(32) - rot))) & np.uint64(0xFFFFFFFF)
        v = (v & keep) | (r & ~keep & np.uint64(0xFFFFFFFF))
    return v


def _warp_model(res, light, d, mask_tab, th, C0, W, S):
    """The CUDA kernels' counting scheme in numpy, one warp per row: per
    32-position chunk a lane orders its candidates by class and forms two
    disjoint planes per mask word (a: the lower class, b: the other & ~a);
    the planes are transposed, and lane s adds
    popcount((Ta & ballot(class A == x)) | (Tb & ballot(class B == x)))."""
    N, P, _ = d.shape
    X = th + 1
    hist = np.zeros((N, S, X), np.int32)
    minall = np.full(N, 255, np.int32)
    for n in range(N):
        for p0 in range(0, P, 32):
            hd = np.full((32, 2), 255, np.int64)
            msk = np.zeros((32, 2, W), np.uint64)
            for ln in range(min(32, P - p0)):
                p = p0 + ln
                if not light[n, p]:
                    continue
                for c in range(C0):
                    if mask_tab is None:
                        enc = d[n, p, 1 + c * (1 + W)]
                        words = d[n, p, 2 + c * (1 + W): 2 + c * (1 + W) + W]
                    else:
                        enc = d[n, p, 1 + c]
                        se = min(int(d[n, p, 1 + C0 + c]), len(mask_tab) - 1)
                        words = mask_tab[se]
                    z = int(enc) ^ int(res[n, p])
                    h = bin((z | z >> 16) & 0xFFFF).count("1")
                    if h <= th and words.any():
                        hd[ln, c] = h
                        msk[ln, c] = words
                        minall[n] = min(minall[n], h)
            swap = hd[:, 1] < hd[:, 0]
            hA = np.where(swap, hd[:, 1], hd[:, 0])
            hB = np.where(swap, hd[:, 0], hd[:, 1])
            lanes = np.uint64(1) << np.arange(32, dtype=np.uint64)
            for w in range(W):
                a = np.where(swap, msk[:, 1, w], msk[:, 0, w])
                b = np.where(swap, msk[:, 0, w], msk[:, 1, w]) & ~a
                ta, tb = _transpose32(a), _transpose32(b)
                for x in range(min(X, 17)):
                    MA = lanes[hA == x].sum(dtype=np.uint64)
                    MB = lanes[hB == x].sum(dtype=np.uint64)
                    cnt = (ta & MA) | (tb & MB)
                    for s in range(min(32, S - 32 * w)):
                        hist[n, 32 * w + s, x] += bin(int(cnt[s])).count("1")
    return hist, minall


@pytest.mark.parametrize("N,P,C0,W,S,th,flavor,leafsets", [
    (3, 70, 2, 2, 48, 4, "embed", "random"),
    (2, 33, 2, 8, 255, 4, "se", "dense"),
    (2, 64, 1, 1, 24, 6, "embed", "last"),
])
def test_warp_counting_scheme_matches_ref(N, P, C0, W, S, th, flavor,
                                          leafsets):
    """The scheme both CUDA kernels use (bit-plane transposes, class
    ballots, one popcount per leaf and class) gives the plain version's
    counts; the kernels themselves are held to it on the card."""
    rng = np.random.default_rng(N + P + S)
    res, light, d, mask_tab = tiles_inputs(rng, N, P, C0, W, S, th, flavor,
                                           False, 97, leafsets)
    want_h, want_m = kernels.probe_hist_tiles_ref(
        *_torch_args(res, light, d, mask_tab), th, C0, W, S)
    got_h, got_m = _warp_model(res, light, d, mask_tab, th, C0, W, S)
    assert np.array_equal(got_h, want_h.numpy())
    assert np.array_equal(got_m, want_m.numpy())
    assert got_h.sum() > 0


def test_tiles_ref_agrees_with_packed_ref_and_bounds_its_chunks(monkeypatch):
    """W = 1 embed rows are the packed kernel's layout: both plain
    versions agree, also when the tiles version runs in row chunks."""
    from krepp_tpu_torch.testing import epilogue_inputs

    rng = np.random.default_rng(8)
    res, light, d = epilogue_inputs(rng, 53, 166, 2, 24, 4)
    args = (_t(res), _t(light), _t(d))
    want = kernels.probe_hist_packed_ref(*args, 4, 2, 24)
    monkeypatch.setattr(kernels, "_REF_ELEMS", 166 * 2 * 24 * 5)
    got = kernels.probe_hist_tiles_ref(*args, None, 4, 2, 1, 24)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_tiles_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    args = _torch_args(*tiles_inputs(rng, 16, 122, 2, 8, 256, 4, "se"))
    before = kernels.probe_hist_tiles.launches
    got = kernels.probe_hist_tiles(*args, 4, 2, 8, 256)
    want = kernels.probe_hist_tiles_ref(*args, 4, 2, 8, 256)
    assert kernels.probe_hist_tiles.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W,S,th,C0", [(2, 70, 4, 2), (3, 70, 4, 3),
                                       (8, 256, 48, 2), (9, 280, 4, 2)])
def test_tiles_rejects_shapes_outside_the_contract(W, S, th, C0):
    res = torch.zeros((4, 10), dtype=torch.int32)
    light = torch.zeros((4, 10), dtype=torch.bool)
    d = torch.zeros((4, 10, 1 + 2 * C0), dtype=torch.int32)
    mask_tab = torch.zeros((5, W), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.probe_hist_tiles(res, light, d, mask_tab, th, C0, W, S)


HDIST_CASES = [(3000, 8, 4), (1537, 4, 4), (1000, 16, 6), (64, 1, 1)]


def _hdist_inputs(rng, N, C):
    res = rng.integers(0, 2 ** 32, N, dtype=np.uint32)
    enc = rng.integers(0, 2 ** 32, (N, C), dtype=np.uint32)
    for i in range(0, N, 3):     # plant close matches
        enc[i, i % C] = res[i] ^ np.uint32(1 << (i % 16))
    cnt = rng.integers(0, C + 1, N, dtype=np.int32)
    return res, enc, cnt


@pytest.mark.parametrize("N,C,th", HDIST_CASES)
def test_hdist_ref_matches_pallas_and_xla(N, C, th):
    """The shapes of tests/test_pallas.py (N not a multiple of the TPU
    tile included)."""
    import jax.numpy as jnp

    from krepp_tpu.query.pallas_kernels import hdist_chunk as jhdist
    from krepp_tpu.query.pallas_kernels import hdist_chunk_xla

    rng = np.random.default_rng(N + C)
    res, enc, cnt = _hdist_inputs(rng, N, C)
    jargs = (jnp.asarray(res), jnp.asarray(enc), jnp.asarray(cnt))
    got = kernels.hdist_chunk_ref(_t(res), _t(enc), _t(cnt), th)
    for want in (jhdist(*jargs, th=th, interpret=True),
                 hdist_chunk_xla(*jargs, th=th)):
        assert np.array_equal(np.asarray(want[0]), got[0].numpy())
        assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert (got[1].numpy() < 255).any()


def test_hdist_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(4)
    args = tuple(_t(a) for a in _hdist_inputs(rng, 100, 8))
    before = kernels.hdist_chunk.launches
    got = kernels.hdist_chunk(*args, 4)
    want = kernels.hdist_chunk_ref(*args, 4)
    assert kernels.hdist_chunk.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    rng = np.random.default_rng(5)
    cases = [c + ("random",) for c in TILES_CASES + [
        (4097, 122, 2, 8, 256, 4, "se", False),
        (999, 374, 2, 1, 24, 4, "embed", False)]] + TILES_STAGING_CASES
    for (N, P, C0, W, S, th, flavor, dark, leafsets) in cases:
        args = _torch_args(*tiles_inputs(rng, N, P, C0, W, S, th, flavor,
                                         dark, 97, leafsets))
        want = kernels.probe_hist_tiles_ref(*args, th, C0, W, S)
        got = kernels.probe_hist_tiles(
            *(None if a is None else a.cuda() for a in args), th, C0, W, S)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    for N, C, th in HDIST_CASES + [(100003, 16, 4)]:
        args = tuple(_t(a) for a in _hdist_inputs(rng, N, C))
        want = kernels.hdist_chunk_ref(*args, th)
        got = kernels.hdist_chunk(*(a.cuda() for a in args), th)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
