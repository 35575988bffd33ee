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


@pytest.mark.parametrize("N,P,C0,W,S,th,flavor,dark", TILES_CASES)
def test_tiles_ref_matches_pallas_interpret(N, P, C0, W, S, th, flavor,
                                             dark):
    import jax.numpy as jnp

    from krepp_tpu.query.pallas_kernels import probe_hist_tiles as jtiles

    rng = np.random.default_rng(N * 7 + P + W + S + th)
    res, light, d, mask_tab = tiles_inputs(rng, N, P, C0, W, S, th, flavor,
                                           dark)
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
    for (N, P, C0, W, S, th, flavor, dark) in TILES_CASES + [
            (4097, 122, 2, 8, 256, 4, "se", False),
            (999, 374, 2, 1, 24, 4, "embed", False)]:
        args = _torch_args(*tiles_inputs(rng, N, P, C0, W, S, th, flavor,
                                         dark))
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
