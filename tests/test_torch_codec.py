"""Port codec vs krepp_tpu's: unpacking, strand hashes, Hamming distance,
bit packing. All integer outputs must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krepp_tpu.core import codec as jcodec
from krepp_tpu.params import LSHParams
from krepp_tpu_torch.core import codec
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)


def _codes(rng, B=7, L=192, n_frac=0.02):
    c = rng.integers(0, 4, (B, L)).astype(np.uint8)
    return np.where(rng.random((B, L)) < n_frac, 4, c).astype(np.uint8)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("with_n", [False, True])
def test_pack_and_unpack_codes_match(with_n):
    rng = np.random.default_rng(1)
    codes = _codes(rng, n_frac=0.03 if with_n else 0.0)
    lengths = rng.integers(100, 193, 7).astype(np.int32)
    packed, vbits = jcodec.pack_codes_host(codes, lengths)
    tp, tv = codec.pack_codes_host(codes, lengths)
    assert np.array_equal(packed, tp)
    assert (vbits is None) == (tv is None) == (not with_n)
    L = codes.shape[1]
    want = jcodec.unpack_codes(jnp.asarray(packed), jnp.asarray(lengths), L,
                               None if vbits is None else jnp.asarray(vbits))
    got = codec.unpack_codes(
        torch.from_numpy(tp.view(np.int32)), torch.from_numpy(lengths), L,
        None if tv is None else torch.from_numpy(tv.view(np.int32)))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("k,h", [(27, 11), (29, 13)])
def test_strand_hashes_match_conv_on_valid_windows(k, h):
    lsh = LSHParams.generate(k, h, 4, seed=k)
    rng = np.random.default_rng(k)
    codes = _codes(rng, B=9, L=256, n_frac=0.01)
    want = jcodec.strand_hashes_conv(jnp.asarray(codes.astype(np.int32)), lsh)
    got = codec.strand_hashes(torch.from_numpy(codes.astype(np.int32)), lsh)
    valid = np.asarray(want[4])
    assert np.array_equal(valid, got[4].numpy())
    assert 0 < valid.sum() < valid.size
    for w, g in zip(want[:4], got[:4]):
        assert np.array_equal(np.where(valid, np.asarray(w), 0),
                              np.where(valid, _u32(g), 0))


@pytest.mark.parametrize("k,h", [(27, 11), (29, 13)])
def test_slice_sums_match_reference_on_every_window(k, h):
    lsh = LSHParams.generate(k, h, 4, seed=k + 1)
    rng = np.random.default_rng(k + 1)
    codes = _codes(rng, B=5, L=128, n_frac=0.05)
    jc = jnp.asarray(codes.astype(np.int32))
    tc = torch.from_numpy(codes.astype(np.int32))
    for jf, tf in ((jcodec.lsh_hash_or, codec.lsh_hash_or),
                   (jcodec.lsh_hash_rc, codec.lsh_hash_rc),
                   (jcodec.residual_or, codec.residual_or),
                   (jcodec.residual_rc, codec.residual_rc)):
        assert np.array_equal(np.asarray(jf(jc, lsh)), _u32(tf(tc, lsh)))
    assert np.array_equal(np.asarray(jcodec.window_valid(jc, k)),
                          codec.window_valid(tc, k).numpy())


def test_hdist_lr32_matches():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2 ** 32, 5000, dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, 5000, dtype=np.uint32)
    b[:100] = a[:100] ^ np.uint32(0x80018001)     # bits 31 and 15 set
    want = jcodec.hdist_lr32(jnp.asarray(a), jnp.asarray(b))
    got = codec.hdist_lr32(torch.from_numpy(a.view(np.int32)),
                           torch.from_numpy(b.view(np.int32)))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("S", [24, 32, 40])
def test_pack_bits_device_matches(S):
    rng = np.random.default_rng(S)
    flags = rng.random((11, S)) < 0.5
    flags[0, :] = True                         # bit 31 of every word set
    want = np.asarray(jcodec.pack_bits_device(jnp.asarray(flags)))
    got = codec.pack_bits_device(torch.from_numpy(flags))
    assert np.array_equal(want, _u32(got))
    assert np.array_equal(codec.unpack_bits_host(got.numpy(), S), flags)
